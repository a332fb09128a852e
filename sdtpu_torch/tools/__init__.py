"""Scripts of the port: the checkpoint converter (host), and measurement probes that run on the card."""

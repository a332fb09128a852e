"""Version introspection, a copy of ``sdtpu/version.py`` (the port imports
nothing of the JAX package): the package version, the git revision of the
tree it runs from, and the two joined."""

import subprocess

__version__ = "0.1.0"


def git_revision(short: bool = True) -> str:
    """Best-effort git revision of the installed tree; '' if unavailable
    (no git, not a checkout, or no answer within 5 s)."""
    try:
        args = ["git", "rev-parse", "--short" if short else "--verify", "HEAD"]
        out = subprocess.run(
            args, capture_output=True, text=True, timeout=5,
            cwd=__file__.rsplit("/", 2)[0],
        )
        return out.stdout.strip() if out.returncode == 0 else ""
    except Exception:
        return ""


def full_version() -> str:
    rev = git_revision()
    return f"{__version__}+git.{rev}" if rev else __version__

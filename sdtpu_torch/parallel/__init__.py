"""Multi-card serving: the (data, model) mesh and its sharding plan, the
counterpart of ``sdtpu/parallel/``.

The reference is a single controller: one process holds a
``jax.sharding.Mesh`` and GSPMD inserts the collectives from sharding
annotations. The port is SPMD, as torch.distributed is: one process a rank,
the collectives written out.

* ``mesh.make_mesh(data, model)`` lays a ``(data, model)`` grid over the
  ranks of a process group the caller started (``torchrun`` or
  ``init_process_group``); with no group the world is one rank and
  ``(1, 1)`` is the only mesh (``single_device_mesh``).
* ``data``: each rank runs its rows of a call's batch; the results are
  gathered over the data group, so every rank returns the whole batch.
* ``model``: Megatron tensor parallelism over the transformer matmul pairs
  (``sharding``): q/k/v/qkv/kv/fc1/ff1 column-parallel, out/fc2/ff2
  row-parallel with one all-reduce of the partial sum, a column site with
  no row partner (the time MLP's fc1) gathered. Convolutions, norms and
  the VAE stay replicated.
* ``collectives`` issues and counts every collective under the names the
  reference counts in its compiled HLO (``sdtpu/parallel/hlo.py``).

* ``spatial``: the reference's spatial partition of the UNet's conv stack
  over the model axis (W-slices, halo exchanges, GroupNorm statistics
  combined across ranks), on around ``sharding.generate_sharded(...,
  spatial=True)``.
* ``follow``: one HTTP front end for a mesh (``sdtpu-torch serve --mesh``):
  rank 0 serves and broadcasts each call, the other ranks make it too.

Entry points: ``Context(mesh=(data, model))`` on every rank;
``sharding.generate_sharded``; ``train.step.make_train_step(..., mesh=,
plan=)`` on each rank's split tree (``sharding.shard_params``, and
``sharding.gather_params`` to put a tree back together); ``sdtpu-torch
serve --mesh d,m``.
"""

"""The multi-card layer: a named device mesh over ``torch.distributed``
(``mesh.py``), collectives for metrics and the process group's start
(``collectives.py``), and the multi-rank dry run (``dryrun.py``).

One process per device: every entry point that takes a ``mesh`` is called by
every rank of the mesh, each on its own device (``cuda:<local rank>`` over
NCCL, or the CPU over gloo when the caller asks for it), with the same
arguments, as a JAX program over a ``Mesh`` is.
"""

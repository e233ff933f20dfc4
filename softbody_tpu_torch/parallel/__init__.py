"""Multi-device execution over torch.distributed (counterpart of
``softbody_tpu/parallel``): particle sharding of the gather backend and the
process group's collectives (``sharding``), its halo exchange (``halo``),
the sparse SPMD episode on the shard-major slot layout (``sparse_shard``)
and :func:`dryrun_multichip` (``dryrun``)."""

from .dryrun import dryrun_multichip

__all__ = ["dryrun_multichip"]

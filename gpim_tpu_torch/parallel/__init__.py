"""The parallel layer (counterpart of ``gpim_tpu/parallel``): meshes over
the ranks of a ``torch.distributed`` world, one process a card
(:mod:`.distributed`, :mod:`.mesh`), the sharded multi-output helpers
(:mod:`.multichip`) and the multi-process worker (:mod:`.mp_worker`)."""

from gpim_tpu_torch.parallel.mesh import (  # noqa: F401
    get_mesh, shard_batch, local_device_count)
from gpim_tpu_torch.parallel import distributed  # noqa: F401

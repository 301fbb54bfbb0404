"""
gpim_tpu_torch.utils: host-side grid/data preparation, mirroring the
reference's ``gpim.gprutils`` namespace. The plotting helpers come with a
later slice of the port.
"""

from gpim_tpu_torch.utils.gridutils import *  # noqa: F401,F403

from gpim_tpu_torch.utils import gridutils as _g

__all__ = list(_g.__all__)

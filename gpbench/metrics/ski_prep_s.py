"""ski_prep_s: seconds a job of the masked-lattice cell spends in the front
door: the grid preparation (utils.get_sparse_grid, get_full_grid), the
skreconstructor's constructor with its lattice detection, and the uploads;
the mean over the jobs outside the traced one.

The reading of ``prep_s``, for the masked-lattice cell, whose end-to-end
metric is the card's time (``bo_device_ms_per_step``), not
``recon_s``."""

from gpbench.harness import find

read = find.load("metrics", "prep_s").read

"""ski_train_ms_per_step: the .train() call of the masked-lattice cell
over its Adam steps, in ms a step, over the jobs outside the traced one.

The reading of ``train_ms_per_step``, for the masked-lattice cell, whose end-to-end
metric is the card's time (``bo_device_ms_per_step``), not
``recon_s``."""

from gpbench.harness import find

read = find.load("metrics", "train_ms_per_step").read

"""ski_predict_s: the .predict() call of the masked-lattice cell (the
predict-time solve, the mean, the Nystrom variance over every cell, and
their read-back), in seconds, the mean over the jobs outside the traced
one.

The reading of ``predict_s``, for the masked-lattice cell, whose end-to-end
metric is the card's time (``bo_device_ms_per_step``), not
``recon_s``."""

from gpbench.harness import find

read = find.load("metrics", "predict_s").read

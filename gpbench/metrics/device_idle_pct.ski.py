"""device_idle_pct.ski: the share of the masked-lattice cell's traced job
in which no operation ran on the card, from the profiler's device
events.

The reading of ``device_idle_pct.recon``, for the masked-lattice cell,
whose end-to-end metric is the card's time (``bo_device_ms_per_step``),
not ``recon_s``."""

from gpbench.harness import find

read = find.load("metrics", "device_idle_pct.recon").read

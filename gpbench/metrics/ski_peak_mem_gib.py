"""ski_peak_mem_gib: torch.cuda.max_memory_allocated over the measured
window of the masked-lattice cell (the allocator's peak, reset when the
window opens), in GiB.

The reading of ``peak_mem_gib``, for the masked-lattice cell, whose end-to-end
metric is the card's time (``bo_device_ms_per_step``), not
``recon_s``."""

from gpbench.harness import find

read = find.load("metrics", "peak_mem_gib").read

"""recon_s: seconds from scan to image, the mean over the window's
completed jobs of each job's clock (grid preparation and the model's
constructor to mean and sd on the host)."""


def read(run):
    clocks = [j["clock_s"] for j in run.jobs if "prep_s" in j]
    return sum(clocks) / len(clocks) if clocks else None

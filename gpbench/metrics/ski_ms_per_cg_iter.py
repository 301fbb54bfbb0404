"""ski_ms_per_cg_iter: the seconds of the ``adam.step`` spans (a step's
loss, CG, SLQ, backward and update) over the realized CG iterations of the
training solves, in ms, over the jobs outside the traced one."""


def read(run):
    jobs = [j for j in run.plain_jobs
            if j.get("cg_iters") and "adam.step" in j.get("spans", {})]
    its = sum(j["cg_iters"] for j in jobs)
    return (1e3 * sum(j["spans"]["adam.step"][0] for j in jobs) / its
            if its else None)

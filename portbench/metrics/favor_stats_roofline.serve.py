"""Hand kernels: ``favor_stats`` (csrc/favor.cu; its split-T sum
``favor_reduce`` counted with it) while serving, the sum of each
launch's bound over the launches' device time.  A launch at [b, H, T, e]
bf16 with m features reads k and v (2 b H T e x 2 bytes) and w, writes
ksum and kptv in float32, and does its bf16x3 design's 6 x 2 m e
operations a row on the tensor cores; each traced request's chunks (the
serving ladder) launch one a block."""

from harness import yardstick


def launch_bound(b, model):
    h, t, e, m = model["heads"], model["tokens"], model["emb_s"], \
        model["features"]
    n_bytes = 2 * b * h * t * e * 2 + m * e * 4 + b * h * m * 4 \
        + b * h * m * e * 4
    return yardstick.bound_s(n_bytes, 6 * b * h * t * 2 * m * e)


def read(trace, work, config, traffic):
    model = config["model"]
    bounds = [launch_bound(b, model)
              for n in work.get("trace_sizes", ())
              for b in yardstick.chunks(n, work["buckets"])
              for _ in range(model["depth"])]
    return yardstick.roofline_pct(trace, ("favor_stats", "favor_reduce"),
                                  "favor_stats", bounds)

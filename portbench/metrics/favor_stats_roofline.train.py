"""Hand kernels: ``favor_stats`` (csrc/favor.cu; ``favor_reduce`` counted
with it) while training: one launch a block a step at [batch, H, T, e]
bf16 (the forward; the backward recomputes by autograd in float32), each
launch's bound (k, v read once in bf16, w read, ksum and kptv written
in float32; the bf16x3 design's 6 x 2 m e operations a row on the
tensor cores) summed over the launches' device time."""

from harness import yardstick


def read(trace, work, config, traffic):
    m = config["model"]
    b, h, t, e, f = work["batch"], m["heads"], m["tokens"], m["emb_s"], \
        m["features"]
    n_bytes = 2 * b * h * t * e * 2 + f * e * 4 + b * h * f * 4 \
        + b * h * f * e * 4
    one = yardstick.bound_s(n_bytes, 6 * b * h * t * 2 * f * e)
    bounds = [one] * (m["depth"] * work.get("trace_steps", 0))
    return yardstick.roofline_pct(trace, ("favor_stats", "favor_reduce"),
                                  "favor_stats", bounds)

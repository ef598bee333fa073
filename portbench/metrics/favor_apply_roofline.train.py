"""Hand kernels: ``favor_apply`` (csrc/favor.cu) while training: one
launch a block a step at [batch, H, T, e] (the forward), each launch's
bound (q read in bf16, w, ksum and kptv read, y written in float32; the
bf16x3 design's 9 x 2 m e operations a row on the tensor cores) summed
over the launches' device time."""

from harness import yardstick


def read(trace, work, config, traffic):
    m = config["model"]
    b, h, t, e, f = work["batch"], m["heads"], m["tokens"], m["emb_s"], \
        m["features"]
    n_bytes = b * h * t * e * 2 + f * e * 4 + b * h * f * 4 \
        + b * h * f * e * 4 + b * h * t * e * 4
    one = yardstick.bound_s(n_bytes, 9 * b * h * t * 2 * f * e)
    bounds = [one] * (m["depth"] * work.get("trace_steps", 0))
    return yardstick.roofline_pct(trace, ("favor_apply",), "favor_apply",
                                  bounds)

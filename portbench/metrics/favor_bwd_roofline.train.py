"""Hand kernels: the FAVOR+ backward (csrc/favor_bwd.cu: the q pass
``favor_bwd_q``, the k, v pass ``favor_bwd_kv`` and, where T is split,
``favor_bwd_reduce``, counted together) while training: one q and one
k, v launch a block a step at [batch, H, T, e] bf16, each pair's bound
(q, k and v read in bf16 and dy in float32, w, ksum and kptv read, dq, dk
and dv written in bf16; the math's eight products of 2 m e operations a
row, each counted once and not as its bf16x3 parts, so that the bound is
a least time) summed over the launches' device time.  A program whose
backward is not these kernels (autograd's recompute) has nothing to
read."""

from harness import yardstick


def read(trace, work, config, traffic):
    m = config["model"]
    b, h, t, e, f = work["batch"], m["heads"], m["tokens"], m["emb_s"], \
        m["features"]
    rows = b * h * t
    n_bytes = rows * e * (3 * 2 + 4 + 3 * 2) + f * e * 4 \
        + b * h * (f + f * e) * 4
    one = yardstick.bound_s(n_bytes, 8 * 2 * f * e * rows)
    bounds = [one] * (m["depth"] * work.get("trace_steps", 0))
    return yardstick.roofline_pct(trace, ("favor_bwd",), "favor_bwd_kv",
                                  bounds)

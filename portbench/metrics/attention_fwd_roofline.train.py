"""Hand kernels: ``attention_fwd`` (csrc/attention_fwd.cu) while
training, the sum of each launch's bound over the launches' device
time: one launch a layer a step at [batch, H, N, Dh] bf16, reading q, k,
v and writing o once (4 b H N Dh x 2 bytes), 4 b H N^2 Dh operations on
the tensor cores."""

from harness import yardstick


def read(trace, work, config, traffic):
    m = config["model"]
    b, h, n, d = work["batch"], m["heads"], m["tokens"], m["dim_head"]
    one = yardstick.bound_s(4 * b * h * n * d * 2, 4 * b * h * n * n * d)
    bounds = [one] * (m["depth"] * work.get("trace_steps", 0))
    return yardstick.roofline_pct(trace, ("attention_fwd",),
                                  "attention_fwd", bounds)

"""fit_overhead_s (s), layer "Trainer chunk loop": the window's wall less
the time its steady chunks took by the program's own rate, i.e. less
the samples after the first chunk over ``TrainResult.samples_per_sec``
(the host clock over the chunks after the first). What is left is the
fit's fixed cost: staging, the memory preflight, the first chunk with
its graph capture and warm-up, and the result's assembly."""


def read(ctx):
    w = ctx.window
    steady = w["samples"] - w["k"] * w["samples_per_epoch"]
    if w["program_samples_per_s"] <= 0 or steady <= 0:
        return None
    return w["wall_s"] - steady / w["program_samples_per_s"]

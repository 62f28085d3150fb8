"""step_mfu (layer: model step; moves actions_per_s): the model operations
of the actions completed in the window (``work.action_flops`` from the
configuration's widths) over the window's seconds at the card's dense bf16
peak (989 TFLOP/s, H100 SXM data sheet; the card's power limit is printed
in the result's ``device``)."""
from ecc_bench import work


def read(r):
    prompt = r.seq - r.config["n_patches"]
    flops = r.actions * work.action_flops(r.config, prompt)
    return 100.0 * flops / (r.window_s * work.PEAK_BF16_FLOPS)

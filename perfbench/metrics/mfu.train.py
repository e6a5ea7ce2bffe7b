"""The whole training step's share of the card's bf16 peak: the model
FLOPs of every worker gradient computed in the window
(``reference/flops.py``: 6 per parameter per token plus causal attention,
no recomputation) over the window's length times the peak."""


def read(ctx):
    peaks = ctx.get("peaks")
    if not peaks or not ctx.get("window_s") or not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"]
                                         * peaks["bf16_flops"])

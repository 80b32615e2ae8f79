"""attn_roofline: the least time of the attention blocks one update's
``model.attn`` spans hold (``counts/openai_hns.py``'s FP32 operations
and bytes, each agent once through its own policy, under
``counts/peaks.py::least_seconds``), over those spans' device time per
update, as a share. It reads spans, so it measures the same work
whatever implements the block."""

from portbench import spans


def read(ctx):
    least = ctx["values"].get("attn_least_s")
    ms = spans.device_ms_per(ctx, "model.attn", "update")
    if least is None or not ms:
        return None
    return 100.0 * least / (ms * 1e-3)

"""torso_roofline: the least time of the torso forwards that one update's
``model.torso`` spans hold (``counts/impala_cnn.py``'s direct-convolution
and dense FLOPs, each agent once through its own policy, and the frames
and weights each read once, under ``counts/peaks.py::least_seconds``),
over those spans' device time per update, as a share. cuDNN's FFT (or
a Winograd) algorithm multiplies less than the direct count, so the share
errs high by at most the ratio between the two; padded rows are not
counted, so it errs low by those."""

from portbench import spans


def read(ctx):
    least = ctx["values"].get("torso_least_s")
    ms = spans.device_ms_per(ctx, "model.torso", "update")
    if least is None or not ms:
        return None
    return 100.0 * least / (ms * 1e-3)

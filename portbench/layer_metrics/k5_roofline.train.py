"""k5_roofline.train: the least time of one launch of K5's frames mode
(``csrc/rgbd.cu``'s ``rgbd_frames_kernel``, the training env's render in
its step): the frozen least-work count on the last frames' depth
(``counts/kernel_ops.py::rgbd_least_ops``) and the bytes the frames mode
must move (``counts/impala_cnn.py::k5_frames_bytes``), over its device
time per launch in the trace."""

from portbench.trace import kernel_time


def read(ctx):
    least = ctx["values"].get("k5_frames_least_s")
    k = kernel_time(ctx["trace"], "rgbd_frames_kernel")
    if least is None or k is None:
        return None
    return 100.0 * least / k[0]

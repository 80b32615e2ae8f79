"""FLOPs and bytes of the ``impala_cnn`` policy, counted from the
configuration's widths, and the bytes of K5's frames mode.

FLOPs: the direct convolutions' and the dense products' multiply-adds
(each two FLOPs): ``9 C_in C_out`` per output pixel of a 3 x 3
convolution, as if computed directly; a Winograd or FFT algorithm does
fewer multiplies, so these counts are the work the network defines, not
what cuDNN's algorithm spends. Biases, ReLUs, the max pools, the
residual sums, the LSTM's gate arithmetic and the LayerNorm are left out,
so every count errs low. Each agent is counted once, through its own
policy; work an implementation does for other policies, rows it pads,
or again (a recomputed torso), is not counted."""

from __future__ import annotations

from portbench.counts import kernel_ops

F32 = 4


def torso_macs(cfg: dict) -> int:
    """One frame through the torso: each section's convolution at the
    section's input size, its residual blocks' two convolutions at the
    pooled size, and the Dense after the flatten."""
    c_in, size = cfg["frame"][0], cfg["frame"][1]
    k2 = cfg["conv_size"] ** 2
    macs = 0
    for ch, blocks in cfg["sections"]:
        macs += k2 * c_in * ch * size * size
        size //= 2
        macs += blocks * 2 * k2 * ch * ch * size * size
        c_in = ch
    return macs + c_in * size * size * cfg["torso_dense"]


def core_macs(cfg: dict) -> int:
    """The LSTM step over the core input (the torso's output, the previous
    reward, one one-hot a bucket, the agent's own observation) and the
    two heads."""
    h = cfg["lstm_channels"]
    core = (cfg["torso_dense"] + 1 + sum(cfg["action_buckets"]) +
            cfg["self_features"])
    return (core + h) * 4 * h + h * (sum(cfg["action_buckets"]) + 1)


def forward_flops(cfg: dict, n: float) -> float:
    """One forward step of ``n`` agents (the shared encoder serves actor
    and critic; past policies run the same pass)."""
    return 2.0 * n * (torso_macs(cfg) + core_macs(cfg))


def ppo_flops(cfg: dict, agent_steps: float, epochs: int) -> float:
    """The PPO update: forward and backward (twice the forward) over the
    trained agents' stored steps, each epoch."""
    return 3.0 * epochs * forward_flops(cfg, agent_steps)


def torso_weight_bytes(cfg: dict) -> int:
    """One policy's torso parameters: every kernel and bias."""
    c_in, size = cfg["frame"][0], cfg["frame"][1]
    k2 = cfg["conv_size"] ** 2
    n = 0
    for ch, blocks in cfg["sections"]:
        n += k2 * c_in * ch + ch + blocks * 2 * (k2 * ch * ch + ch)
        size //= 2
        c_in = ch
    n += c_in * size * size * cfg["torso_dense"] + cfg["torso_dense"]
    return F32 * n


def torso_work(cfg: dict, frames: float, policy_calls: float):
    """(FLOPs, bytes) of ``frames`` torso forwards in calls that hold
    ``policy_calls`` policies' torsos in all: each frame read once and
    its 256 features written once, each policy's weights read once a
    call. The activations between the layers are left out of the bytes:
    a fused torso would keep them on chip."""
    c, h, w = cfg["frame"]
    flops = 2.0 * torso_macs(cfg) * frames
    n_bytes = (frames * F32 * (c * h * w + cfg["torso_dense"]) +
               policy_calls * torso_weight_bytes(cfg))
    return flops, float(n_bytes)


def k5_frames_bytes(ps, frames) -> float:
    """Bytes one launch of K5's frames mode must read and write: the
    primitives' leaves (``kernel_ops.rgbd_bytes``'s) and the frames
    ``[W, A, 4, H, W]`` float32 it writes, each once."""
    return kernel_ops.rgbd_bytes(ps, frames, frames[:0])


def k5_frames_least_ops(frames, max_depth: float) -> float:
    """``kernel_ops.rgbd_least_ops`` on the frames' depth channel (a hit
    where depth > 0)."""
    return kernel_ops.rgbd_least_ops(frames[:, :, 3] * max_depth)

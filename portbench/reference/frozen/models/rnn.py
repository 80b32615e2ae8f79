# Frozen copy of marl_hideandseek_torch/models/rnn.py at commit fbfc592641d85df17e7487fd9f1855010c549ebb,
# the plain reference of the benchmark: imports renamed to this folder,
# every kernel dispatch replaced by its plain version. Do not edit.
"""Recurrent cells: LSTM with explicit functional state.

Port of ``marl_hideandseek_tpu/models/rnn.py``: create and clear the
recurrent state outside the module, apply one step during rollouts, replay
a stored sequence (clearing the state at episode ends) for BPTT. The
state is ``(h, c)``, each ``[num_layers, N, C]`` float32 per agent; inside
the ensemble forward it carries the policy axis in front (``[P|1, L, N,
C]``, see ``models/layers.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from portbench.reference.frozen.models.layers import Dense, orthogonal

State = Tuple[torch.Tensor, torch.Tensor]


class LSTM(nn.Module):
    """Multi-layer LSTM (rnn.py:17-88). Layer i has ``layer_{i}_ih`` (with
    a bias) and ``layer_{i}_hh`` (without); gates split i, f, g, o along
    4C and are computed in float32, with the forget gate's +1.0 added in
    the forward pass, not stored in a parameter."""

    def __init__(self, num_policies: int, in_features: int,
                 num_hidden_channels: int, num_layers: int = 1,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_hidden_channels = num_hidden_channels
        self.num_layers = num_layers
        self.dtype = dtype
        c = num_hidden_channels
        for i in range(num_layers):
            setattr(self, f"layer_{i}_ih", Dense(
                num_policies, in_features if i == 0 else c, 4 * c,
                kernel_init=orthogonal(1.0), dtype=dtype, device=device))
            setattr(self, f"layer_{i}_hh", Dense(
                num_policies, c, 4 * c, use_bias=False,
                kernel_init=orthogonal(1.0), dtype=dtype, device=device))

    def init_recurrent_state(self, batch_size: int, device=None) -> State:
        shape = (self.num_layers, batch_size, self.num_hidden_channels)
        return (torch.zeros(shape, device=device),
                torch.zeros(shape, device=device))

    @staticmethod
    def clear_recurrent_state(rnn_states: State, should_clear) -> State:
        """Zero the state where ``should_clear`` ([N] or [N, 1]) is set, by
        multiplying with 1 - mask as JAX does: a NaN state stays NaN."""
        h, c = rnn_states
        mask = should_clear.reshape(-1, 1).to(h.dtype)
        return h * (1.0 - mask), c * (1.0 - mask)

    def _cell(self, i: int, h, c, x):
        # ih(x) + hh(h): the hidden product adds the input one in its call.
        ih = getattr(self, f"layer_{i}_ih")(x)
        gates = getattr(self, f"layer_{i}_hh")(h.to(self.dtype), add=ih)
        i_g, f_g, g_g, o_g = torch.chunk(gates.to(torch.float32), 4, dim=-1)
        i_g = torch.sigmoid(i_g)
        f_g = torch.sigmoid(f_g + 1.0)
        g_g = torch.tanh(g_g)
        o_g = torch.sigmoid(o_g)
        c_new = f_g * c + i_g * g_g
        h_new = o_g * torch.tanh(c_new)
        return h_new, c_new

    def forward(self, rnn_states: State, x: torch.Tensor,
                train: bool = False):
        """One step. x ``[P|1, N, F]``, states ``[P|1, L, N, C]``. Returns
        (out ``[P, N, C]`` in the compute dtype, new states ``[P, L, N,
        C]``)."""
        h_all, c_all = rnn_states
        new_h, new_c = [], []
        inp = x
        for layer in range(self.num_layers):
            h, c = self._cell(layer, h_all[:, layer], c_all[:, layer], inp)
            new_h.append(h)
            new_c.append(c)
            inp = h.to(self.dtype)
        return inp, (torch.stack(new_h, 1), torch.stack(new_c, 1))

    def sequence(self, start_states: State, seq_ends: torch.Tensor,
                 seq_x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Replay a stored sequence for BPTT. seq_x ``[P|1, T, N, F]``,
        seq_ends ``[T, N]``, or ``[P, T, N]`` when each policy replays its
        own agents: the state is cleared (multiplied by 1 - end) after each
        step where the episode ended. Returns ``[P, T, N, C]``."""
        keep = 1.0 - seq_ends.reshape((-1,) + seq_ends.shape[-2:]).to(
            torch.float32)                                     # [P|1, T, N]
        states = start_states
        outs = []
        for t in range(seq_x.shape[1]):
            out, (h, c) = self(states, seq_x[:, t], train)
            k = keep[:, t, None, :, None]
            states = (h * k, c * k)
            outs.append(out)
        return torch.stack(outs, 1)

"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``): the
SimpleRNN, LSTM and GRU cells and the multi-layer, bidirectional sequence
wrappers.

The gate semantics and the parameters are the JAX package's, names and
layouts alike (``weight_ih [gates * hidden, input]``, ``weight_hh [gates
* hidden, hidden]``, ``bias_ih``, ``bias_hh``, all ``Uniform(-1/sqrt(H),
1/sqrt(H))``), so ``convert.layer_from_jax`` carries the weights across
as they are: LSTM gate chunks are ``[i, f, g, o]`` with ``h = o *
tanh(c)``; GRU splits ``[r, z, c]`` with the candidate ``tanh(x_c + r *
h_c)`` and ``h = (prev - c) * z + c``.

The JAX ``_scan_cell`` (a ``lax.scan``) is a loop over the time steps
here, each step the cell's ``_step`` on the whole batch; torch autograd
records it. With ``sequence_length`` a step past a sequence's end gives
a zero output and carries the state through unchanged, so the final
state is each sequence's state at its last valid step; the mask is
built on the lengths' device. ``BiRNN`` registers its two cells once (the
JAX state dict's keys ``cell_fw.*``/``cell_bw.*``); its ``rnn_fw`` and
``rnn_bw`` drive them. No Pallas kernel is involved in the JAX package,
and none here.
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from ..initializer import Uniform
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


class RNNCellBase(Layer):
    """A single-step cell with ``get_initial_states``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0):
        """Zero (``init_value``) states ``[batch, *state_shape]`` in
        float32 on ``batch_ref``'s device, as in the JAX package (which
        takes ``shape`` and ``dtype`` and ignores them)."""
        batch = batch_ref.shape[0]

        def full(s):
            return torch.full((batch,) + tuple(s), init_value,
                              dtype=torch.float32, device=batch_ref.device)

        state_shape = self.state_shape
        if isinstance(state_shape[0], tuple):
            return tuple(full(s) for s in state_shape)
        return full(state_shape)

    def _make(self, gates, input_size, hidden_size):
        init = Uniform(-1.0 / math.sqrt(hidden_size),
                       1.0 / math.sqrt(hidden_size))
        self.weight_ih = self.create_parameter(
            [gates * hidden_size, input_size], default_initializer=init)
        self.weight_hh = self.create_parameter(
            [gates * hidden_size, hidden_size], default_initializer=init)
        self.bias_ih = self.create_parameter(
            [gates * hidden_size], default_initializer=init)
        self.bias_hh = self.create_parameter(
            [gates * hidden_size], default_initializer=init)
        self.input_size = input_size
        self.hidden_size = hidden_size

    def _params(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


class SimpleRNNCell(RNNCellBase):
    """``h' = act(W_ih x + b_ih + W_hh h + b_hh)``, ``act`` tanh or
    relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self._make(1, input_size, hidden_size)
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _step(self, x, h, w_ih, w_hh, b_ih, b_hh):
        gates = x @ w_ih.T + b_ih + h @ w_hh.T + b_hh
        nh = torch.tanh(gates) if self.activation == "tanh" \
            else torch.relu(gates)
        return nh, nh

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        return self._step(inputs, states, *self._params())


class LSTMCell(RNNCellBase):
    """Gates chunked ``[i, f, g, o]``; returns ``(h, (h, c))``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self._make(4, input_size, hidden_size)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def _step(self, x, h, c, w_ih, w_hh, b_ih, b_hh):
        gates = x @ w_ih.T + b_ih + h @ w_hh.T + b_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        nc = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(nc), nc

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h, c = states
        nh, nc = self._step(inputs, h, c, *self._params())
        return nh, (nh, nc)


class GRUCell(RNNCellBase):
    """Splits ``[r, z, c]``; ``h = (prev - c) * z + c``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self._make(3, input_size, hidden_size)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def _step(self, x, h, w_ih, w_hh, b_ih, b_hh):
        x_r, x_z, x_c = torch.chunk(x @ w_ih.T + b_ih, 3, dim=-1)
        h_r, h_z, h_c = torch.chunk(h @ w_hh.T + b_hh, 3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        c = torch.tanh(x_c + r * h_c)
        nh = (h - c) * z + c
        return nh, nh

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        return self._step(inputs, states, *self._params())


def _scan_cell(cell, x_seq, init, reverse=False, mask=None):
    """Run ``cell._step`` over ``x_seq [T, B, I]`` (back to front when
    ``reverse``). ``mask [T, B, 1]`` bool: a masked step's output is zero
    and the state carries through. Returns ``(ys [T, B, H], final)``."""
    is_lstm = isinstance(cell, LSTMCell)
    params = cell._params()
    carry, ys = init, [None] * x_seq.shape[0]
    steps = range(x_seq.shape[0])
    for t in (reversed(steps) if reverse else steps):
        if is_lstm:
            nh, nc = cell._step(x_seq[t], carry[0], carry[1], *params)
            new = (nh, nc)
        else:
            nh, _ = cell._step(x_seq[t], carry, *params)
            new = nh
        if mask is not None:
            mt = mask[t]
            new = (torch.where(mt, nh, carry[0]),
                   torch.where(mt, nc, carry[1])) if is_lstm \
                else torch.where(mt, nh, carry)
            nh = torch.where(mt, nh, torch.zeros((), dtype=nh.dtype,
                                                 device=nh.device))
        carry, ys[t] = new, nh
    return torch.stack(ys), carry


class RNN(Layer):
    """Runs a cell over a sequence: ``inputs [B, T, I]`` (``[T, B, I]``
    when ``time_major``); returns ``(outputs, final_states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        cell = self.cell
        is_lstm = isinstance(cell, LSTMCell)
        if initial_states is None:
            batch = inputs.shape[1] if self.time_major else inputs.shape[0]
            zeros = torch.zeros((batch, cell.hidden_size),
                                dtype=torch.float32, device=inputs.device)
            initial_states = (zeros, zeros.clone()) if is_lstm else zeros
        x_seq = inputs if self.time_major else inputs.transpose(0, 1)
        mask = None
        if sequence_length is not None:
            slen = torch.as_tensor(sequence_length, device=inputs.device)
            mask = (torch.arange(x_seq.shape[0], device=inputs.device)[:, None]
                    < slen.reshape(1, -1))[:, :, None]
        init = tuple(initial_states) if is_lstm else initial_states
        ys, final = _scan_cell(cell, x_seq, init, self.is_reverse, mask)
        return (ys if self.time_major else ys.transpose(0, 1)), final


class BiRNN(Layer):
    """A forward and a backward cell over the same sequence, outputs
    concatenated on the feature axis; final states ``(fw, bw)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major
        # the wrappers drive the cells registered above; kept out of the
        # module tree so each parameter has one state-dict key
        object.__setattr__(self, "rnn_fw", RNN(cell_fw, False, time_major))
        object.__setattr__(self, "rnn_bw", RNN(cell_bw, True, time_major))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = (initial_states if initial_states
                                is not None else (None, None))
        out_fw, st_fw = self.rnn_fw(inputs, states_fw, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, states_bw, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class RNNBase(Layer):
    """A stack of ``num_layers`` RNN (or BiRNN with ``direction=
    "bidirect"``) layers of ``_cell_cls``; dropout between layers in
    training. Initial and final states in the reference layout
    ``[num_layers * num_directions, B, H]`` (a pair of them for LSTM)."""

    _cell_cls = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 **cell_kwargs):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"bad direction {direction!r}")
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.input_size = input_size
        self.time_major = time_major
        self.dropout = dropout
        self._layers = []
        num_dir = 2 if self.bidirectional else 1
        for i in range(num_layers):
            in_sz = input_size if i == 0 else hidden_size * num_dir
            if self.bidirectional:
                layer = BiRNN(self._cell_cls(in_sz, hidden_size,
                                             **cell_kwargs),
                              self._cell_cls(in_sz, hidden_size,
                                             **cell_kwargs),
                              time_major=time_major)
            else:
                layer = RNN(self._cell_cls(in_sz, hidden_size,
                                           **cell_kwargs),
                            time_major=time_major)
            self.add_sublayer(f"layer_{i}", layer)
            self._layers.append(layer)

    def _split_initial(self, initial_states):
        """``[num_layers * num_dirs, B, H]`` states (a pair for LSTM) to
        each layer's state structure."""
        if initial_states is None:
            return [None] * self.num_layers
        is_lstm = isinstance(initial_states, (tuple, list)) and \
            len(initial_states) == 2 and \
            getattr(initial_states[0], "ndim", 0) == 3
        per_layer = []
        for i in range(self.num_layers):
            if is_lstm:
                h_all, c_all = initial_states
                if self.bidirectional:
                    per_layer.append((
                        (h_all[2 * i], c_all[2 * i]),
                        (h_all[2 * i + 1], c_all[2 * i + 1])))
                else:
                    per_layer.append((h_all[i], c_all[i]))
            elif self.bidirectional:
                per_layer.append((initial_states[2 * i],
                                  initial_states[2 * i + 1]))
            else:
                per_layer.append(initial_states[i])
        return per_layer

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs
        finals = []
        per_layer_states = self._split_initial(initial_states)
        for i, layer in enumerate(self._layers):
            x, st = layer(x, per_layer_states[i], sequence_length)
            finals.append(st)
            if self.dropout and i < self.num_layers - 1 and self.training:
                x = F.dropout(x, p=self.dropout, training=True)
        return x, self._stack_finals(finals)

    def _stack_finals(self, finals):
        per_dir = [g for f in finals
                   for g in ((f[0], f[1]) if self.bidirectional else (f,))]
        if isinstance(per_dir[0], tuple):  # LSTM: (h, c) pairs
            return (torch.stack([p[0] for p in per_dir]),
                    torch.stack([p[1] for p in per_dir]))
        return torch.stack(per_dir)


class SimpleRNN(RNNBase):
    _cell_cls = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation)


class LSTM(RNNBase):
    _cell_cls = LSTMCell


class GRU(RNNBase):
    _cell_cls = GRUCell

"""Multi-layer LSTM + token classifier decoder.

Counterpart of deephumor_tpu/models/lstm.py. A layer is PyTorch's
``nn.LSTM`` layout: ``{"weight_ih" [4H, in], "weight_hh" [4H, H],
"bias_ih" [4H], "bias_hh" [4H]}`` with the gates in the order (i, f, g, o)
(convert/jax_params.py transposes the JAX package's ``wi [in, 4H]`` and
``wh [H, 4H]``). The JAX package runs no Pallas kernel here, and neither
does the port: the cell is two ``F.linear`` products and pointwise ops,
the time loop a Python loop. The training forward
(:func:`lstm_decoder_forward`) prepends the image embedding as the step-0
input and applies PyTorch's inter-layer dropout in train mode.
"""

import math

import torch
import torch.nn.functional as F

from deephumor_tpu_torch.models import layers as L

__all__ = ["lstm_init", "lstm_forward", "lstm_step", "lstm_decoder_init",
           "lstm_decoder_forward"]


def lstm_init(gen, input_dim, hidden_size, num_layers, device="cuda"):
    """Uniform(-1/sqrt(H), 1/sqrt(H)) weights and biases, as PyTorch's."""
    bound = 1.0 / math.sqrt(hidden_size)

    def u(*shape):
        x = torch.rand(shape, generator=gen, device=device)
        return (x * 2.0 - 1.0) * bound

    return [{"weight_ih": u(4 * hidden_size,
                            input_dim if i == 0 else hidden_size),
             "weight_hh": u(4 * hidden_size, hidden_size),
             "bias_ih": u(4 * hidden_size), "bias_hh": u(4 * hidden_size)}
            for i in range(num_layers)]


def _cell(layer, x, h, c):
    """One LSTM cell step; gate order (i, f, g, o)."""
    gates = (F.linear(x, layer["weight_ih"], layer["bias_ih"])
             + F.linear(h, layer["weight_hh"], layer["bias_hh"]))
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_forward(params, x, h0=None, c0=None, dropout=0.0, train=False,
                 gen=None):
    """Full-sequence forward of ``x [bs, T, in]``, layer by layer. In
    train mode every layer's output but the last takes ``dropout`` (drawn
    from ``gen``), as PyTorch's stacked LSTM does.

    Returns:
        (outputs ``[bs, T, H]``, (h ``[L, bs, H]``, c ``[L, bs, H]``))
    """
    if (h0 is None) != (c0 is None):
        raise ValueError("pass both h0 and c0 or neither")
    bs, hidden = x.shape[0], params[0]["weight_hh"].shape[1]
    if h0 is None:
        h0 = c0 = x.new_zeros((len(params), bs, hidden))
    hs, cs, seq = [], [], x
    for k, layer in enumerate(params):
        h, c, outs = h0[k], c0[k], []
        for t in range(seq.shape[1]):
            h, c = _cell(layer, seq[:, t], h, c)
            outs.append(h)
        seq = torch.stack(outs, dim=1)
        hs.append(h)
        cs.append(c)
        if k < len(params) - 1:
            seq = L.dropout(gen, seq, dropout, train)
    return seq, (torch.stack(hs), torch.stack(cs))


def lstm_step(params, x, h, c):
    """One decode step through every layer: ``x [bs, in]``, ``h, c
    [L, bs, H]`` -> (top layer's output ``[bs, H]``, (h, c))."""
    hs, cs = [], []
    for k, layer in enumerate(params):
        x, ck = _cell(layer, x, h[k], c[k])
        hs.append(x)
        cs.append(ck)
    return x, (torch.stack(hs), torch.stack(cs))


def lstm_decoder_init(gen, num_tokens, emb_dim=256, hidden_size=512,
                      num_layers=3, device="cuda"):
    """Random decoder parameters (same tree as the JAX
    ``lstm_decoder_init``): token embedding, LSTM layers, classifier."""
    return {
        "embedding": L.embedding_init(gen, num_tokens, emb_dim, device),
        "lstm": lstm_init(gen, emb_dim, hidden_size, num_layers, device),
        "classifier": L.linear_init(gen, hidden_size, num_tokens, device),
    }


def lstm_decoder_forward(params, image_emb, captions, dropout=0.0,
                         train=False, gen=None):
    """Teacher-forced forward: the image embedding ``[bs, emb_dim]`` is the
    step-0 input and the caption tokens ``[bs, T]`` follow; returns logits
    ``[bs, T+1, num_tokens]``."""
    x = torch.cat([image_emb[:, None, :],
                   L.embed(params["embedding"], captions)], dim=1)
    outputs, _ = lstm_forward(params["lstm"], x, dropout=dropout, train=train,
                              gen=gen)
    return L.linear(params["classifier"], outputs)

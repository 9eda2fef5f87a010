"""The captioner's train step: teacher-forced loss, its gradients, the
global-norm clip and Adam, in f32 over the whole global batch.

From cached trunk features ``[B, 7, 7, 2048]``: the global embedding is
the mean of the grid through the head's linear layer and a train-mode
batch norm (the batch's mean and biased variance), the spatial embedding
each cell through the same linear layer; no dropout (the steps that it
follows run at dropout 0). The decoder (reference/captioner.py) reads
the start embedding and ``captions[:, :-1]`` and scores ``captions``;
the loss is the mean cross-entropy over the targets that are not the
pad. Gradients are taken in blocks of rows (the batch norm's statistics
over the whole batch first), so that the batch fits. The clip scales the
gradients by ``clip / norm`` when their global norm reaches ``clip``;
Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) then steps every
trainable leaf.

``precision="fp8"`` is the control: every product's operands rounded to
fp8 e4m3 in the forward and the gradients that flow back through them to
fp8 e5m2 (per-tensor scales), as an fp8 training step runs its products.
"""

import math

import torch

from perfbench.reference import captioner as ref

B1, B2, EPS = 0.9, 0.999, 1e-8


E5M2_MAX = 57344.0


class _Fp8(torch.autograd.Function):
    """e4m3 forward, e5m2 gradient."""

    @staticmethod
    def forward(ctx, x):
        return ref.fp8(x)

    @staticmethod
    def backward(ctx, grad):
        scale = grad.abs().amax().clamp_min(1e-30) / E5M2_MAX
        return (grad / scale).to(torch.float8_e5m2).to(grad.dtype) * scale


class TrainMath(ref.Math):
    def __init__(self, precision="f32"):
        super().__init__("f32")
        if precision == "fp8":
            self.round = _Fp8.apply


def flat(tree, prefix=""):
    """``{'a/b/0/c': leaf}`` of a nested dict/list tree."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(flat(v, key + "/"))
        else:
            out[key] = v
    return out


def trainable(key):
    """Every leaf but the batch norm's running statistics."""
    return not key.endswith(("running_mean", "running_var"))


def head(enc, feats, m):
    """(start [B, D], spatial [B, 49, D]) of trunk features."""
    grid = feats.reshape(feats.shape[0], -1, feats.shape[-1])
    lin = enc["linear"]
    x = m.linear(lin, grid.mean(1))
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    bn = enc["bn"]
    start = (x - mean) / torch.sqrt(var + 1e-5) * bn["weight"] + bn["bias"]
    return start, m.linear(lin, grid)


def decoder_logits(dec, start, spatial, fed, n_heads, m, pad_index=0):
    """Logits ``[b, T + 1, V]`` after ``start`` over the fed tokens ``fed
    [b, T]`` (the captioner's decoder, with ``m``'s products)."""
    b, t = fed.shape
    d = start.shape[-1]
    length = t + 1
    emb = torch.cat([start[:, None], dec["tok_embedding"]["weight"][fed]], 1)
    x = emb / math.sqrt(d) + dec["pos_embedding"]["weight"][:length]
    key_ok = torch.cat([torch.ones_like(fed[:, :1], dtype=torch.bool),
                        fed != pad_index], 1)
    future = torch.ones(length, length, dtype=torch.bool,
                        device=x.device).triu(1)
    self_masked = future[None] | ~key_ok[:, None, :]
    enc_masked = (spatial == 0).any(-1)[:, None, :].expand(
        b, length, spatial.shape[1])
    for layer in dec["layers"]:
        x = ref.layer_norm(layer["self_attn_ln"], x + ref.attention(
            m, layer["self_attn"], x, x, n_heads, self_masked))
        x = ref.layer_norm(layer["enc_attn_ln"], x + ref.attention(
            m, layer["enc_attn"], x, spatial, n_heads, enc_masked))
        ff = m.linear(layer["pf"]["fc_2"],
                      torch.relu(m.linear(layer["pf"]["fc_1"], x)))
        x = ref.layer_norm(layer["pf_ln"], x + ff)
    return m.linear(dec["classifier"], x)


def loss_and_grads(params, feats, captions, n_heads, precision="f32",
                   rows=None, block=64, pad_index=0):
    """(loss, {flat key: gradient}) of the mean cross-entropy over the
    batch (``rows``: only these rows, the mean over them; a fault of the
    step), in blocks of ``block`` rows."""
    m = TrainMath(precision)
    if rows is not None:
        feats, captions = feats[rows], captions[rows]
    leaves = {k: v for k, v in flat(params).items() if trainable(k)}
    for v in leaves.values():
        v.requires_grad_(True)
        v.grad = None
    start, spatial = head(params["encoder"], feats, m)
    s_leaf = start.detach().requires_grad_(True)
    p_leaf = spatial.detach().requires_grad_(True)
    n_tok = int((captions != pad_index).sum())
    total = 0.0
    for i in range(0, captions.shape[0], block):
        sl = slice(i, i + block)
        cap = captions[sl]
        logits = decoder_logits(params["decoder"], s_leaf[sl], p_leaf[sl],
                                cap[:, :-1], n_heads, m, pad_index)
        logp = torch.log_softmax(logits, -1)
        nll = -logp.gather(-1, cap[..., None])[..., 0]
        part = (nll * (cap != pad_index)).sum() / n_tok
        part.backward()
        total += float(part.detach())
    torch.autograd.backward([start, spatial], [s_leaf.grad, p_leaf.grad])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    for v in leaves.values():
        v.requires_grad_(False)
        v.grad = None
    return total, grads


@torch.no_grad()
def adam_step(params, grads, state, lr, clip):
    """Clips ``grads`` by their global norm and steps ``params`` in place;
    ``state``: ``{"count", "mu", "nu"}`` (made at the first step).
    Returns the clipped gradients."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    scale = 1.0 if norm < clip else float(clip / norm)
    leaves = flat(params)
    if not state:
        state.update(count=0, mu={k: torch.zeros_like(g)
                                  for k, g in grads.items()},
                     nu={k: torch.zeros_like(g) for k, g in grads.items()})
    state["count"] += 1
    c1, c2 = 1 - B1 ** state["count"], 1 - B2 ** state["count"]
    clipped = {}
    for k, g in grads.items():
        g = g * scale
        clipped[k] = g
        mu = state["mu"][k].mul_(B1).add_(g, alpha=1 - B1)
        nu = state["nu"][k].mul_(B2).addcmul_(g, g, value=1 - B2)
        leaves[k].sub_(lr * (mu / c1) / (torch.sqrt(nu / c2) + EPS))
    return clipped


def run_steps(params, feats, batches, n_heads, lr, clip, precision="f32",
              rows=None):
    """Three (or ``len(batches)``) steps from ``params`` (changed in
    place): (losses, the first step's clipped gradients)."""
    state, losses, first = {}, [], None
    for captions in batches:
        loss, grads = loss_and_grads(params, feats[captions["rows"]],
                                     captions["captions"], n_heads,
                                     precision, rows)
        clipped = adam_step(params, grads, state, lr, clip)
        losses.append(loss)
        if first is None:
            first = clipped
    return losses, first


def leaf_gaps(got, want, skip=()):
    """The worst leaf's gap between two trees' norms: ``|norm(got) -
    norm(want)|`` over the larger of ``norm(want)`` and the median leaf's
    norm, over the keys of ``want`` not in ``skip``. Returns (gap, key)."""
    norms = {k: float(torch.linalg.vector_norm(v.detach().double()))
             for k, v in want.items() if k not in skip}
    med = sorted(norms.values())[len(norms) // 2]
    worst = (0.0, None)
    for k, n in norms.items():
        g = float(torch.linalg.vector_norm(got[k].detach().double()))
        gap = abs(g - n) / max(n, med)
        if gap > worst[0]:
            worst = (gap, k)
    return worst


def still_leaves(grads, share=1e-3):
    """The leaves whose gradient is nought to rounding: a norm under
    ``share`` of the median leaf's (a key's bias under softmax, a bias
    ahead of a train-mode batch norm). Adam moves them by round-off
    alone, so their change is not compared."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k for k, n in norms.items() if n < share * med}

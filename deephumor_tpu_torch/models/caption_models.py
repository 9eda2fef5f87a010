"""The four captioning models: teacher-forced training forwards and
generation.

Counterparts of deephumor_tpu/models/caption_models.py:

- ``CaptioningLSTM``: ResNet-50 global embedding -> LSTM decoder.
- ``CaptioningLSTMWithLabels``: image + template-label embedding -> LSTM
  decoder whose token embedding is the label encoder's table.
- ``CaptioningTransformerBase``: global embedding -> decoder-only
  transformer.
- ``CaptioningTransformer``: ResNet-50 spatial encoder -> cross-attention
  transformer decoder, word- or character-level.
- ``CaptioningMLAMoE`` (the port's own, no JAX counterpart): an image
  prefix -> DeepSeek-V3's latent-attention and sparse-expert decoder
  (Kimi-VL's language model, models/mla_moe.py).

The LSTMs generate by batched beam search over their (h, c) state, which
follows the surviving branches row by row. The transformers generate over
KV caches that are never reordered (ancestry tables select each branch's
history; see models/transformer.py).

Long generations (the char config: 128 steps) add the JAX package's two
phase-boundary transforms. Early-EOS compaction moves the items whose
every branch has ended to the batch tail, and the kernels skip them.
Canonical-prefix attention gathers each item's common ancestor path below
``c`` once into a shared cache, so the kernels read one row per position
there instead of ``beam``.

Training runs ``forward`` (teacher forcing, plain PyTorch ops, no
kernel), never ``encode``: that runs under ``torch.inference_mode``,
whose tensors refuse autograd. ``trunk`` gives the frozen ResNet-50's
features, which a trainer caches per template and passes back with
``from_trunk=True``.

Each model is a frozen dataclass of hyperparameters; its parameters are
a nested dict of tensors (``init``, ``from_pretrained``), on the card
unless the caller asks for the CPU. Generation runs where the parameters
live: on a CUDA device the decode path goes through the hand-written
kernels, on the CPU through their plain twins. On a CUDA device the
decode loop replays as CUDA graphs unless the caller passes
``compiled=False`` (models/graphs.py: the counterpart of the JAX
package's compiled ``generate``); ``generate`` from images encodes them
inside the prefill's graph. Parameters placed on a
``data x model`` mesh (``parallel.make_param_shardings``: DTensors) make
``generate_from_emb`` run ``parallel.tp_generate``: each rank decodes its
data block over its local shards (``model_group``, see
models/transformer.py), captured as one card's loop is when the group
is NCCL.
"""

import dataclasses
import functools
import math
import os

import torch

from deephumor_tpu_torch import EOS
from deephumor_tpu_torch.convert.jax_params import (params_from_jax,
                                                    params_to_jax)
from deephumor_tpu_torch.models import graphs
from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.models import mla_moe
from deephumor_tpu_torch.models import transformer as tfm
from deephumor_tpu_torch.models.encoders import (
    image_encoder_apply, image_encoder_init, image_encoder_trunk,
    image_label_encoder_apply, image_label_encoder_init)
from deephumor_tpu_torch.models.lstm import (lstm_decoder_forward,
                                             lstm_decoder_init, lstm_forward,
                                             lstm_step)
from deephumor_tpu_torch.models import sampling
from deephumor_tpu_torch.models.sampling import (BeamSearch,
                                                 inv_temperature,
                                                 noise_shapes)
from deephumor_tpu_torch.ops.attention import MASK_FILL, ancestry_bias
from deephumor_tpu_torch.ops.engine import fused_survivor_update
from deephumor_tpu_torch.parallel.sharding import local_tree, placed_mesh
from deephumor_tpu_torch.utils import profiling
from deephumor_tpu_torch.utils.pytree import (load_params, save_params,
                                              tree_map)

__all__ = ["CaptioningLSTM", "CaptioningLSTMWithLabels",
           "CaptioningTransformerBase", "CaptioningTransformer",
           "CaptioningMLAMoE", "MODEL_REGISTRY"]

_SAMPLERS = ("exact", "pallas")
# canonical prefix length c = p_eff - _CANON_LAG: the still-diverging
# window [c, p_eff) stays per slot
_CANON_LAG = 16
# the LSTM's steps per captured graph (it has no phases); ended.all() is
# read between graphs
_GRAPH_STEPS = 8


def _tile_rows(x, n):
    """``x.repeat_interleave(n, 0)`` as a broadcast copy into a new
    contiguous tensor: each row ``n`` times in a row, with no size
    computed on the device (a captured prefill may not wait for it)."""
    out = x.new_empty((x.shape[0] * n, *x.shape[1:]))
    out.view(x.shape[0], n, *x.shape[1:]).copy_(x[:, None])
    return out


def _check_sampler(sampler):
    sampler = sampler or "exact"
    if sampler not in _SAMPLERS:
        raise ValueError(f"sampler must be one of {_SAMPLERS}")
    return sampler


def _tp_generate(model, params, enc, kwargs):
    """``generate_from_emb`` of a tree placed on a mesh: runs
    ``parallel.tp_generate`` (which calls back with the local shards)."""
    from deephumor_tpu_torch.parallel.mesh import tp_generate

    kwargs = dict(kwargs)
    return tp_generate(model, params, enc, placed_mesh(params),
                       generator=kwargs.pop("generator"), **kwargs)


def _cast(tree, dtype_name):
    """``tree`` (decoder parameters, embeddings) in the model's compute
    dtype: the encoder -> decoder seam of generation and of ``forward``
    (the JAX package's ``_decoder_compute_cast``). Casting the parameters
    alone would leave every product in f32, so the encoder's output is
    cast too. The cast is differentiable: the gradients of f32 master
    parameters come back in f32."""
    dt = getattr(torch, dtype_name)
    return tree if dt == torch.float32 else tree_map(lambda t: t.to(dt), tree)


class _Captioner:
    """Loading, saving and the training forward's tail, shared by the four
    models."""

    def _decoder(self, params):
        return params["decoder"]

    def _forward(self, params, encoded, train, decode):
        """The tail of every ``forward``: ``encoded`` is the encoder's
        output (in train mode ``(output, new encoder params)``), cast at
        the seam with the decoder's parameters and fed to ``decode(dec,
        encoded)``. Returns the logits, in train mode ``(logits,
        new_params)`` with the encoder's batch-norm statistics
        advanced."""
        if train:
            encoded, new_enc = encoded
        dec, encoded = _cast((self._decoder(params), encoded),
                             self.compute_dtype)
        logits = decode(dec, encoded)
        return (logits, dict(params, encoder=new_enc)) if train else logits

    def _from_images(self, params, inputs, kw):
        """``generate`` from ``inputs`` (the images; the labelled LSTM's
        labels after them): the encoder runs at the start of the prefill,
        so on the card it is part of the prefill's graph and the call
        replays whole, the image shape part of the key. A tree placed on a
        mesh encodes first, then runs ``parallel.tp_generate``."""
        if placed_mesh(params) is not None:
            return self.generate_from_emb(
                params, self.encode(local_tree(params), *inputs.values()),
                **kw)
        return self._generate(
            params, inputs,
            lambda x: self.encode(params, *(x[k] for k in inputs)), **kw)

    def hp(self):
        """The hyperparameters a checkpoint records (``compute_dtype``
        only when it is not float32, as the JAX package writes them)."""
        hp = dataclasses.asdict(self)
        if hp.get("compute_dtype") == "float32":
            hp.pop("compute_dtype")
        return hp

    def save(self, params, path):
        """Writes ``params`` as the JAX package's ``.npz`` + ``.json``
        checkpoint (its layout, float32), which its ``load_params`` and
        ``from_pretrained`` read, and so does :meth:`from_pretrained`."""
        save_params(path, params_to_jax(params),
                    {"model_type": self.model_type, **self.hp()})

    @classmethod
    def from_torch(cls, path, device="cuda"):
        """Loads a reference ``.pth`` checkpoint (``{'model': state_dict,
        'hp': dict}``) of this class; returns ``(model, params)``."""
        from deephumor_tpu_torch.convert.torch_import import (
            load_torch_checkpoint)

        tree, hp = load_torch_checkpoint(path, cls.model_type)
        params = tree_map(lambda t: t.to(device), params_from_jax(tree))
        return cls(**hp), params

    @classmethod
    def from_pretrained(cls, path, device="cuda"):
        """Loads a ``.npz`` + ``.json`` checkpoint saved by the JAX
        package's ``save``; returns ``(model, params)``. The checkpoint's
        ``model_type`` picks the class: this one or a subclass (so
        ``CaptioningTransformerBase`` loads either transformer)."""
        tree, hp = load_params(path)
        hp = dict(hp or {})
        model_type = hp.pop("model_type", cls.model_type)
        model_cls = MODEL_REGISTRY.get(model_type)
        if model_cls is None or not issubclass(model_cls, cls):
            raise ValueError(f"checkpoint holds a {model_type!r} model, not "
                             f"a {cls.__name__}")
        params = tree_map(lambda t: t.to(device), params_from_jax(tree))
        return model_cls(**hp), params


@dataclasses.dataclass(frozen=True)
class CaptioningLSTM(_Captioner):
    """LSTM captioner conditioned on the global image embedding.

    ``compute_dtype="bfloat16"`` runs the decoder in bf16 (the serving
    configuration); the encoder always runs in f32.
    """

    num_tokens: int
    emb_dim: int = 256
    hidden_size: int = 512
    num_layers: int = 2
    enc_dropout: float = 0.3
    dec_dropout: float = 0.1
    compute_dtype: str = "float32"

    model_type = "captioning_lstm"
    with_labels = False

    def init(self, gen, device="cuda"):
        """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
        ``device``)."""
        return {
            "encoder": image_encoder_init(gen, self.emb_dim, device),
            "decoder": lstm_decoder_init(
                gen, self.num_tokens, self.emb_dim, self.hidden_size,
                self.num_layers, device),
        }

    def trunk(self, params, images):
        """Frozen-ResNet features ``[bs, 7, 7, 2048]`` of NHWC images, made
        without a gradient and the same at every step: cache them and
        train with ``forward(..., from_trunk=True)``
        (``Trainer.build_trunk_cache``)."""
        return image_encoder_trunk(params["encoder"], images)

    def forward(self, params, images, captions, lengths=None, train=False,
                gen=None, from_trunk=False, group=None, model_group=None):
        """Teacher-forced logits ``[bs, T+1, num_tokens]`` of ``captions
        [bs, T]`` (the image embedding is step 0). In train mode, with
        dropout drawn from ``gen``, returns ``(logits, new_params)``;
        ``group`` (a mesh's data axis, of whose global batch this is a
        shard) pools the encoder's batch-norm moments. ``model_group`` is
        taken for the transformers' signature: an LSTM has no sharded
        leaf, and every rank of the model axis runs it whole.
        ``lengths`` is not needed: a one-way LSTM's outputs before each
        length are the same with or without the reference's packing."""
        return self._forward(
            params, image_encoder_apply(
                params["encoder"], images, dropout=self.enc_dropout,
                train=train, gen=gen, from_trunk=from_trunk, group=group),
            train,
            lambda dec, emb: lstm_decoder_forward(
                dec, emb, captions, self.dec_dropout, train, gen))

    @torch.inference_mode()
    def encode(self, params, images):
        """NHWC images -> global embedding ``[bs, emb_dim]`` (cacheable per
        template)."""
        return image_encoder_apply(params["encoder"], images)

    def _prefill(self, dec, emb, prefix):
        """Runs the image embedding (and the prefix tokens) through the
        LSTM: the first draw's logits and the batch-first state
        ``{"h", "c": [bs, layers, H]}`` that the engine gathers by row."""
        inputs = emb[:, None, :]
        if prefix is not None:
            inputs = torch.cat([inputs, L.embed(dec["embedding"], prefix)],
                               dim=1)
        outs, (h, c) = lstm_forward(dec["lstm"], inputs)
        logits = L.linear(dec["classifier"], outs[:, -1])
        return logits, {"h": h.transpose(0, 1), "c": c.transpose(0, 1)}

    @staticmethod
    def _make_step(dec, return_hidden):
        def step(state, tokens):
            out, (h, c) = lstm_step(
                dec["lstm"], L.embed(dec["embedding"], tokens),
                state["h"].transpose(0, 1), state["c"].transpose(0, 1))
            if not return_hidden:
                # else the draw applies the classifier
                out = L.linear(dec["classifier"], out)
            return out, {"h": h.transpose(0, 1), "c": c.transpose(0, 1)}

        return step

    def _program(self, params, encode, num_items, dev, caption, *, max_len,
                 beam_size, top_k, eos_index, greedy, sampler):
        """One call as a :class:`graphs.Program`: the encoder
        (``encode(inputs)``, which takes the embedding from the inputs or
        encodes the images there) and the prefill with the first draw,
        then the steps in segments of ``_GRAPH_STEPS`` (a graph each on
        the card), then the final pick."""
        prefix_len = 0 if caption is None else caption.shape[1]

        def begin(inputs, noise):
            dec, emb = _cast((self._decoder(params), encode(inputs)),
                             self.compute_dtype)
            logits, state = self._prefill(dec, emb, inputs["caption"])
            state = {k: _tile_rows(v, beam_size)
                     for k, v in state.items()}
            classifier = None
            if sampler == "pallas" and not greedy:
                cls = dec["classifier"]
                classifier = (cls["weight"], cls["bias"])
            search = BeamSearch(
                step_fn=self._make_step(dec, classifier is not None),
                segment_steps=_GRAPH_STEPS, beam_size=beam_size,
                top_k=top_k, inv_t=inputs["inv_t"], max_len=max_len,
                prefix_len=prefix_len, greedy=greedy, sampler=sampler,
                classifier=classifier, eos_index=eos_index)
            return search.start(noise, state, logits, inputs["caption"])

        return graphs.Program(
            begin=begin, finish=lambda search: search.finish(),
            noise=noise_shapes(steps=max_len - prefix_len,
                               num_items=num_items, beam_size=beam_size,
                               top_k=top_k, sampler=sampler, greedy=greedy),
            device=dev)

    @torch.inference_mode()
    def generate_from_emb(self, params, emb, generator=None, caption=None,
                          max_len=25, temperature=1.0, beam_size=10,
                          top_k=50, eos_index=EOS, greedy=False,
                          sampler=None, model_group=None, compiled=None):
        """Batched generation from (possibly cached) image embeddings
        ``[B, emb_dim]``; arguments and result as
        :meth:`CaptioningTransformer.generate_from_emb` (no phases, no
        compaction: the state is a few rows per branch; on the card the
        steps replay as graphs of up to 8 steps). With
        ``sampler="pallas"`` the steps return hidden states and the draw
        runs the classifier: inside K4 up to V = 16384, as a bf16 product
        before K3 above it. A tree placed on a mesh runs
        ``parallel.tp_generate``; the LSTM has no sharded leaf, so every
        rank of the model axis runs it whole (``model_group`` is unused)."""
        kw = dict(generator=generator, caption=caption, max_len=max_len,
                  temperature=temperature, beam_size=beam_size, top_k=top_k,
                  eos_index=eos_index, greedy=greedy, sampler=sampler,
                  compiled=compiled)
        if placed_mesh(params) is not None:
            return _tp_generate(self, params, emb, kw)
        with profiling.span("model.generate"):
            return self._generate(params, {"enc": emb}, lambda x: x["enc"],
                                  **kw)

    @torch.inference_mode()
    def _generate(self, params, inputs, encode, *, generator, caption,
                  temperature, compiled, **static):
        """One generation call from ``inputs`` (the embedding, or images and
        labels) that ``encode`` turns into the embedding at the start of
        the prefill: on the card the encoder is then part of the prefill's
        graph."""
        static["sampler"] = _check_sampler(static["sampler"])
        first = next(iter(inputs.values()))
        num_items, dev = first.shape[0], first.device
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        inputs = dict(inputs, caption=caption,
                      inv_t=inv_temperature(temperature, dev))
        return graphs.generate(
            lambda: self._program(params, encode, num_items, dev, caption,
                                  **static), inputs,
            generator, compiled=compiled,
            key=lambda: graphs.graph_key(self, params, inputs, **static))

    def generate(self, params, images, generator=None, caption=None,
                 max_len=25, temperature=1.0, beam_size=10, top_k=50,
                 eos_index=EOS, greedy=False, sampler=None, compiled=None):
        """Batched caption generation from NHWC images ``[B, H, W, 3]``
        (ImageNet-normalized; the encoder inside the call:
        :meth:`_from_images`); arguments as :meth:`generate_from_emb`."""
        return self._from_images(params, {"images": images}, dict(
            generator=generator, caption=caption, max_len=max_len,
            temperature=temperature, beam_size=beam_size, top_k=top_k,
            eos_index=eos_index, greedy=greedy, sampler=sampler,
            compiled=compiled))


@dataclasses.dataclass(frozen=True)
class CaptioningLSTMWithLabels(CaptioningLSTM):
    """LSTM captioner conditioned on image + template label; the decoder's
    token embedding is the label encoder's table, stored once under the
    encoder."""

    model_type = "captioning_lstm_labels"
    with_labels = True

    def init(self, gen, device="cuda"):
        dec = lstm_decoder_init(gen, self.num_tokens, self.emb_dim,
                                self.hidden_size, self.num_layers, device)
        del dec["embedding"]
        return {"encoder": image_label_encoder_init(
                    gen, self.num_tokens, self.emb_dim, device),
                "decoder": dec}

    def _decoder(self, params):
        return dict(params["decoder"],
                    embedding=params["encoder"]["label_encoder"]["embedding"])

    def trunk(self, params, images):
        return image_encoder_trunk(params["encoder"]["image_encoder"], images)

    def forward(self, params, images, captions, lengths=None, labels=None,
                train=False, gen=None, from_trunk=False, group=None,
                model_group=None):
        """As :meth:`CaptioningLSTM.forward`, conditioned on the label
        tokens ``labels [bs, n]`` too."""
        return self._forward(
            params, image_label_encoder_apply(
                params["encoder"], images, labels, dropout=self.enc_dropout,
                train=train, gen=gen, from_trunk=from_trunk, group=group),
            train,
            lambda dec, emb: lstm_decoder_forward(
                dec, emb, captions, self.dec_dropout, train, gen))

    @torch.inference_mode()
    def encode(self, params, images, labels):
        """NHWC images and label tokens ``[B, n]`` -> joint embedding
        ``[B, emb_dim]``."""
        return image_label_encoder_apply(params["encoder"], images, labels)

    def generate(self, params, images, labels, generator=None, caption=None,
                 max_len=25, temperature=1.0, beam_size=10, top_k=50,
                 eos_index=EOS, greedy=False, sampler=None, compiled=None):
        """Batched caption generation from NHWC images and label tokens;
        arguments and the encoder as :meth:`CaptioningLSTM.generate`."""
        return self._from_images(
            params, {"images": images, "labels": labels}, dict(
                generator=generator, caption=caption, max_len=max_len,
                temperature=temperature, beam_size=beam_size, top_k=top_k,
                eos_index=eos_index, greedy=greedy, sampler=sampler,
                compiled=compiled))


@dataclasses.dataclass(frozen=True)
class CaptioningTransformerBase(_Captioner):
    """Decoder-only transformer captioner on the global image embedding.

    ``compute_dtype="bfloat16"`` runs the decoder in bf16 (the serving
    configuration); the encoder always runs in f32.
    """

    num_tokens: int
    hid_dim: int = 512
    n_layers: int = 6
    n_heads: int = 8
    pf_dim: int = 2048
    enc_dropout: float = 0.3
    dec_dropout: float = 0.1
    pad_index: int = 0
    max_len: int = 128
    compute_dtype: str = "float32"

    model_type = "captioning_transformer_base"
    with_labels = False
    cross_attention = False

    def init(self, gen, device="cuda"):
        """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
        ``device``)."""
        init_fn = (tfm.transformer_decoder_init if self.cross_attention
                   else tfm.self_attn_decoder_init)
        return {
            "encoder": image_encoder_init(gen, self.hid_dim, device),
            "decoder": init_fn(gen, self.num_tokens, self.hid_dim,
                               self.n_layers, self.pf_dim, self.max_len,
                               device),
        }

    def trunk(self, params, images):
        """Frozen-ResNet features ``[bs, 7, 7, 2048]``; see
        :meth:`CaptioningLSTM.trunk`."""
        return image_encoder_trunk(params["encoder"], images)

    def forward(self, params, images, captions, lengths=None, train=False,
                gen=None, from_trunk=False, group=None, model_group=None):
        """Teacher-forced logits ``[bs, T+1, num_tokens]`` of ``captions
        [bs, T]`` after the global image embedding; in train mode
        ``(logits, new_params)``, as :meth:`CaptioningLSTM.forward`.
        ``model_group``: ``params`` holds this rank's tensor-parallel
        shards (models/transformer.py)."""
        return self._forward(
            params, image_encoder_apply(
                params["encoder"], images, dropout=self.enc_dropout,
                train=train, gen=gen, from_trunk=from_trunk, group=group),
            train,
            lambda dec, emb: tfm.self_attn_decoder_forward(
                dec, captions, emb, self.n_heads, self.pad_index,
                self.dec_dropout, train, gen, model_group))

    @torch.inference_mode()
    def encode(self, params, images):
        """NHWC images -> global emb ``[bs, D]`` (cacheable per
        template)."""
        return image_encoder_apply(params["encoder"], images)

    def _prefill(self, dec, start_emb, prefix, max_positions, cross=None,
                 enc_key_mask=None, model_group=None):
        """Feeds the start embedding (and the prefix tokens) through
        ``decode_step``: the first draw's logits and the cache state."""
        bs = start_emb.shape[0]
        scale = math.sqrt(self.hid_dim)
        cache = tfm.init_cache(dec, bs, max_positions, dtype=start_emb.dtype)
        valid = torch.zeros((bs, max_positions), dtype=torch.bool,
                            device=start_emb.device)
        valid[:, 0] = True
        logits, cache = tfm.decode_step(
            dec, start_emb / scale, 0, cache, valid, self.n_heads, cross,
            enc_key_mask, model_group=model_group)
        pos = 1
        for i in range(0 if prefix is None else prefix.shape[1]):
            tok = prefix[:, i]
            valid[:, pos] = tok != self.pad_index
            emb = L.embed(dec["tok_embedding"], tok) / scale
            logits, cache = tfm.decode_step(
                dec, emb, pos, cache, valid, self.n_heads, cross,
                enc_key_mask, model_group=model_group)
            pos += 1
        return logits, {"cache": cache, "valid": valid, "pos": pos}

    def _prefill_and_state(self, dec, enc, prefix, max_positions,
                           pad_to_tile=False, model_group=None):
        """(first logits, decoder state, per-item constants or None)."""
        return (*self._prefill(dec, enc, prefix, max_positions,
                               model_group=model_group), None)

    def _make_step(self, dec, consts, p_eff, return_hidden, canon_c=None,
                   pack_items=None, model_group=None):
        scale = math.sqrt(self.hid_dim)

        def step(state, tokens):
            pos, valid, anc = state["pos"], state["valid"], state["anc"]
            valid[:, pos] = tokens != self.pad_index
            # this step's K/V land in the branch's own physical slot
            anc[:, :, pos] = torch.arange(anc.shape[1], device=anc.device)
            # with compaction the cross-attention K/V and the encoder mask
            # follow the item permutation, so they live in the state, and
            # cross_t_real with them (the JAX package reads it from consts
            # only, so under compaction its packed kernel never runs); the
            # decoder-only model has none of them
            src = consts if consts is not None else state
            canon = None
            if canon_c is not None:
                canon = {"c": canon_c, **{k: state[k] for k in (
                    "shared", "bias_sh", "strag_ids", "n_strag")}}
            emb = L.embed(dec["tok_embedding"], tokens) / scale
            out, cache = tfm.decode_step(
                dec, emb, pos, state["cache"], valid, self.n_heads,
                src.get("cross"), src.get("enc_key_mask"), anc=anc,
                p_eff=p_eff, return_hidden=return_hidden,
                live_items=state.get("live"), canon=canon,
                cross_t_real=src.get("cross_t_real"),
                pack_items=pack_items, model_group=model_group)
            return out, dict(state, cache=cache, pos=pos + 1)

        return step

    @staticmethod
    def _shuffle_state(state, flat_branch, branch):
        """Survivor reorder without touching the KV caches: validity
        follows the branch, the ancestry table re-roots onto the surviving
        branch's history. Per-item entries (compaction, canon) pass
        through."""
        anc = state["anc"]
        return dict(state, valid=state["valid"][flat_branch],
                    anc=anc.gather(1, branch[:, :, None].expand_as(anc)))

    @staticmethod
    def _compact_state(state, seq, val, ended, prefix_positions=None):
        """Early-EOS compaction at a phase boundary: a stable partition
        that moves every item whose branches have all ended to the batch
        tail, and the new live count that the kernels read (``live``, and
        the draw's ``live_rows``: 0-d int32 tensors, set here on the
        device). Results equal the uncompacted run's (ended branches only
        append pads at score 0); ``_finalize_compaction`` undoes the order,
        which is kept in place in ``item_perm`` (the final pick of a
        captured call reads it there, whichever boundaries ran).

        ``prefix_positions``: the finished phase's p_eff. Cache positions
        past it are still their initial zeros, the same in every row, so
        only the prefix is gathered (in place).
        """
        num_items, beam = ended.shape
        dead = ended.all(dim=1)
        order = torch.sort(dead.to(torch.int8), stable=True).indices
        flat = (order[:, None] * beam
                + torch.arange(beam, device=order.device)).reshape(-1)
        for layer in state["cache"]:
            for x in layer.values():
                pp = x.shape[1] if prefix_positions is None else min(
                    prefix_positions, x.shape[1])
                x[:, :pp] = x[flat, :pp]
        state["item_perm"].copy_(state["item_perm"][order])
        live = (~dead).sum(dtype=torch.int32)
        # cross_t_real, a host int, passes through unchanged
        new_state = dict(state, valid=state["valid"][flat],
                         anc=state["anc"][order], live=live,
                         live_rows=live * beam)
        if "cross" in state:
            new_state["cross"] = [{k: v[order] for k, v in c.items()}
                                  for c in state["cross"]]
            new_state["enc_key_mask"] = state["enc_key_mask"][order]
        return new_state, seq[order], val[order], ended[order]

    @staticmethod
    def _finalize_compaction(state, out):
        """Puts the outputs back in the caller's item order."""
        inv = torch.argsort(state["item_perm"])
        return {k: v[inv] for k, v in out.items()}

    @staticmethod
    def _canonicalize_state(state, seq, val, ended, *, c):
        """Phase-boundary setup of canonical-prefix attention.

        For every item whose live branches all descend from one ancestor
        path below ``c``, that path's cache rows are gathered once into a
        per-layer ``shared`` cache ``[B, c, D]``, which K5 reads instead
        of ``beam`` slots per position. Items whose live branches disagree
        (stragglers) are listed first in ``strag_ids`` (``n_strag`` of
        them, a 0-d int32 tensor that K6 reads) and recomputed full-width
        by K6, which writes their rows over K5's. ``strag_rows`` marks
        those rows, as the JAX package's state does for its row-mask
        merge; the decode step does not read it. Agreement below
        ``c`` persists for the rest of the phase (survivors inherit live
        ancestries; ended branches' outputs are discarded), so one gather
        per boundary is exact.
        """
        anc = state["anc"]
        num_items, beam, _ = anc.shape
        live_b = ~ended
        first_live = live_b.to(torch.int8).argmax(dim=1)
        path = anc[:, :, :c].gather(
            1, first_live[:, None, None].expand(-1, 1, c))[:, 0]
        agree = ((anc[:, :, :c] == path[:, None, :])
                 | ~live_b[:, :, None]).all(dim=2).all(dim=1)
        is_strag = live_b.any(dim=1) & ~agree
        # stragglers first, each group in item order
        strag_ids = torch.sort((~is_strag).to(torch.int8),
                               stable=True).indices.to(torch.int32)
        rowsel = (torch.arange(num_items, device=anc.device)[:, None] * beam
                  + path)
        possel = torch.arange(c, device=anc.device)[None, :]
        shared = [{"sk": layer["k"][rowsel, possel],
                   "sv": layer["v"][rowsel, possel]}
                  for layer in state["cache"]]
        valid = state["valid"].reshape(num_items, beam, -1)[:, :, :c]
        sval = valid.gather(1, first_live[:, None, None].expand(-1, 1, c))
        bias_sh = torch.where(sval, 0.0, MASK_FILL).to(torch.float32)
        new_state = dict(
            state, shared=shared, bias_sh=bias_sh, strag_ids=strag_ids,
            n_strag=is_strag.sum(dtype=torch.int32),
            strag_rows=is_strag[:, None].expand(-1, beam).reshape(-1))
        return new_state, seq, val, ended

    @staticmethod
    def _chain_boundaries(fns):
        def run(state, seq, val, ended):
            for fn in fns:
                state, seq, val, ended = fn(state, seq, val, ended)
            return state, seq, val, ended

        return run

    def _program(self, params, encode, num_items, caption, *, max_len,
                 beam_size, top_k, greedy, eos_index, sampler, compact, canon,
                 model_group, pack_items, fused_survivor):
        """One call as a :class:`graphs.Program`: the encoder
        (``encode(inputs)``, which takes the encoder output from the inputs
        or encodes the images there), the prefill and the first draw, then
        the phases and the boundaries between them (each a graph on the
        card), then the final pick. ``pack_items`` and ``fused_survivor``:
        the two switches, read by the caller."""
        prefix_len = 0 if caption is None else caption.shape[1]
        kw = dict(max_len=max_len, beam_size=beam_size, top_k=top_k,
                  greedy=greedy, eos_index=eos_index, sampler=sampler,
                  compact=compact, canon=canon, model_group=model_group,
                  pack_items=pack_items, fused_survivor=fused_survivor)

        def finish(search):
            return dict(search.finish(), boundaries=list(
                search.state.get("boundaries", ())))

        return graphs.Program(
            begin=lambda inputs, noise: self._begin(
                params, encode(inputs), inputs["caption"], inputs["inv_t"],
                noise, **kw),
            finish=finish,
            noise=noise_shapes(steps=max_len - prefix_len,
                               num_items=num_items, beam_size=beam_size,
                               top_k=top_k, sampler=sampler, greedy=greedy),
            device=params["decoder"]["classifier"]["weight"].device,
            read_out=self._read_boundaries, group=model_group)

    def _begin(self, params, enc, caption, inv_t, noise, *, max_len,
               beam_size, top_k, greedy, eos_index, sampler, compact, canon,
               model_group, pack_items, fused_survivor):
        """The prefill, the phase ladder and the first draw: the started
        :class:`BeamSearch` of one call."""
        dec, enc = _cast((params["decoder"], enc), self.compute_dtype)
        # the fused QKV weights, once a call (in the prefill's graph)
        dec = tfm.fuse_qkv(dec)
        prefix_len = 0 if caption is None else caption.shape[1]
        max_positions = max_len + 1
        logits, state, consts = self._prefill_and_state(
            dec, enc, caption, max_positions, pad_to_tile=pack_items > 1,
            model_group=model_group)
        # decoder state is tiled per beam (item-major rows); the
        # cross-attention K/V stay per item
        state["cache"] = [{k: _tile_rows(v, beam_size)
                           for k, v in layer.items()}
                          for layer in state["cache"]]
        state["valid"] = _tile_rows(state["valid"], beam_size)
        num_items = logits.shape[0]
        dev = logits.device
        # every beam slot holds its own copy of the prefill cache
        state["anc"] = torch.arange(beam_size, device=dev)[
            None, :, None].expand(num_items, beam_size,
                                  max_positions).contiguous()
        classifier = None
        if sampler == "pallas" and not greedy:
            cls = dec["classifier"]
            classifier = (cls["weight"], cls["bias"])
        steps = max_len - prefix_len
        # early-EOS compaction: on by default for long generations of many
        # items, where most items end well before the last step
        use_compact = (num_items >= 32 and steps >= 64
                       if compact is None else compact)
        live_fn = finalize_fn = None
        if use_compact:
            # ints until the first compaction sets device counts
            state["live"] = num_items
            state["live_rows"] = num_items * beam_size
            state["item_perm"] = torch.arange(num_items, device=dev)
            state.update(consts or {})
            consts = None
            live_fn = lambda st: st["live_rows"]  # noqa: E731
            finalize_fn = self._finalize_compaction
        use_canon = True if canon is None else canon
        # phase ladder: the attention kernels read only the first p_eff
        # cache positions, which grow with the decode position (step s
        # needs p_eff >= prefix_len + s + 1); the last phase reads only
        # through the last written position
        p_cache = -(-max_positions // 8) * 8
        pes = [pe for pe in range(16, p_cache, 8)
               if 1 <= pe - prefix_len - 1 < steps - 1]
        # phase k runs canon when the boundary before it can set up a
        # canonical prefix c = pe - lag >= 24 (and pe >= 48: on a short
        # runway the boundary gathers cost more than they save)
        canon_cs = [None] + [
            pe - _CANON_LAG
            if use_canon and pe - _CANON_LAG >= 24 and pe >= 48 else None
            for pe in (pes + [p_cache])[1:]]
        p_last = min(p_cache, -(-(prefix_len + steps) // 8) * 8)
        phases = [(pe - prefix_len - 1,
                   self._make_step(dec, consts, pe, classifier is not None,
                                   canon_cs[k], pack_items, model_group))
                  for k, pe in enumerate(pes)]
        phases.append((steps - 1, self._make_step(
            dec, consts, p_last, classifier is not None, canon_cs[-1],
            pack_items, model_group)))
        # boundaries: compaction at pe = 24, 48, 96, ... (each pass gathers
        # the cache prefix, so they are sparse), canonicalisation before
        # every canon phase, after the compaction of the same boundary so
        # its straggler ids index the permuted order. A boundary leaves its
        # counts in device memory, where the next phase's kernels read
        # them: on the card each boundary is a graph (models/graphs.py).
        compactors, last_c = [], 0
        for k, pe in enumerate(pes):
            fns = []
            compacts = use_compact and pe >= 24 and pe >= 2 * last_c
            if compacts:
                fns.append(functools.partial(self._compact_state,
                                             prefix_positions=pe))
                last_c = pe
            if canon_cs[k + 1] is not None:
                fns.append(functools.partial(self._canonicalize_state,
                                             c=canon_cs[k + 1]))
            if fns:
                fns.append(functools.partial(
                    self._record_boundary, pe, compacts,
                    canon_cs[k + 1] is not None))
            compactors.append(self._chain_boundaries(fns) if fns else None)
        survivor_update_fn = None
        if fused_survivor:
            pad_index = self.pad_index

            def survivor_update_fn(st, new_idx, new_val, surv, ended, val,
                                   seq, pos):
                n, bm = surv.shape
                # the survivor draw's picks are a slice of a sort
                chosen, val, ended, seq, anc, valid = fused_survivor_update(
                    new_idx, new_val, surv.contiguous(), ended, val, seq,
                    st["anc"],
                    st["valid"].reshape(n, bm, -1), pos, beam=bm,
                    eos_index=eos_index, pad_index=pad_index,
                    live_items=st.get("live"))
                st = dict(st, anc=anc, valid=valid.reshape(n * bm, -1))
                return st, seq, val, ended, chosen

        search = BeamSearch(
            shuffle_fn=self._shuffle_state, phases=phases,
            beam_size=beam_size, top_k=top_k, inv_t=inv_t,
            max_len=max_len, prefix_len=prefix_len, greedy=greedy,
            sampler=sampler, classifier=classifier, live_fn=live_fn,
            compactors=compactors, finalize_fn=finalize_fn,
            survivor_update_fn=survivor_update_fn, eos_index=eos_index,
            pad_index=self.pad_index)
        return search.start(noise, state, logits, caption)

    @staticmethod
    def _record_boundary(pe, compacted, canon, state, seq, val, ended):
        """Notes what a boundary left in the state's ``boundaries``: the
        live items after its compaction and the stragglers of its canon
        set-up (None for a part that did not run), as the 0-d tensors that
        the kernels read (``_read_boundaries`` reads them at the end)."""
        entry = {"p_eff": pe,
                 "live": state["live"] if compacted else None,
                 "stragglers": state["n_strag"] if canon else None}
        return (dict(state, boundaries=state.get("boundaries", ()) + (
            entry,)), seq, val, ended)

    @staticmethod
    def _read_boundaries(out, ran):
        """The outputs with ``boundaries`` as host ints: the first ``ran``
        boundaries (all for None) read from the device at once, after the
        last step of the call."""
        marks = out["boundaries"][:ran]
        counts = [v for m in marks for v in m.values()
                  if isinstance(v, torch.Tensor)]
        values = iter(sampling.host_read(torch.stack(counts)) if counts
                      else ())
        return dict(out, boundaries=[
            {k: next(values) if isinstance(v, torch.Tensor) else v
             for k, v in m.items()} for m in marks])

    @torch.inference_mode()
    def generate_from_emb(self, params, enc, generator=None, caption=None,
                          max_len=25, temperature=1.0, beam_size=10,
                          top_k=50, eos_index=EOS, greedy=False,
                          sampler=None, compact=None, canon=None,
                          model_group=None, compiled=None):
        """Batched generation from (possibly cached) ``encode`` output.

        Args:
            enc: the global emb ``[B, D]``, or, for
                :class:`CaptioningTransformer`, ``(global emb [B, D],
                spatial emb [B, T, D])``.
            generator: ``torch.Generator`` on the parameters' device
                (default: seeded with 0).
            caption: optional ``[B, prefix_len]`` fixed first tokens.
            sampler: "exact" (default; sorted f32 top-k) or "pallas" (the
                sampler kernels K3/K4; the serving path).
            compact: early-EOS compaction; None (default) turns it on for
                at least 32 items and 64 steps.
            canon: canonical-prefix attention; None (default) is on, and it
                engages only in phases with p_eff >= 48.
            model_group: the ``model`` axis's process group when
                ``params`` holds this rank's tensor-parallel shards (as
                ``parallel.tp_generate`` passes them; models/transformer.py).
                Parameters placed on a mesh (DTensors) run
                ``parallel.tp_generate`` instead, with ``enc`` the whole
                batch on every rank or data-sharded DTensors. Over an
                NCCL group the loop replays as graphs that hold the
                layer-steps' all-reduces (every rank of the group makes
                the same calls); over gloo it runs eagerly, and
                ``compiled=True`` raises ``ValueError``.
            compiled: on a CUDA device, None (default) replays the decode
                loop as CUDA graphs (models/graphs.py: one per phase and
                per phase boundary, made at the first call of each static
                configuration and batch size, whatever the temperature);
                False runs it one step at a time from the host, with the
                same outputs. On the CPU the loop always runs eagerly.

        Two environment variables, read at each call, select kernels as in
        the JAX package: ``DH_CROSS_PACK=<ng>`` runs decode
        cross-attention in K9 (ng items per block over a store padded to
        8 rows; 0 or unset: K2; no effect without cross-attention) and
        ``DH_FUSED_SURVIVOR=1`` runs the
        survivor update in K10. Neither changes a draw when compaction is
        off; with it on, K10 leaves retired items' branches unpermuted.

        Returns:
            dict with ``sequences [B, beam, max_len]``, ``scores``,
            ``chosen [B, max_len]``, ``ended`` and ``boundaries``: one dict
            per phase boundary that ran (``p_eff`` of the phase before
            it, ``live`` items after its compaction, ``stragglers`` of its
            canon set-up; None where that part did not run).
        """
        kw = dict(generator=generator, caption=caption, max_len=max_len,
                  temperature=temperature, beam_size=beam_size, top_k=top_k,
                  eos_index=eos_index, greedy=greedy, sampler=sampler,
                  compact=compact, canon=canon, compiled=compiled)
        if placed_mesh(params) is not None:
            return _tp_generate(self, params, enc, kw)
        with profiling.span("model.generate"):
            return self._generate(params, {"enc": enc}, lambda x: x["enc"],
                                  model_group=model_group, **kw)

    @torch.inference_mode()
    def _generate(self, params, inputs, encode, *, generator, caption,
                  max_len, temperature, compiled, model_group=None,
                  **static):
        """One generation call from ``inputs`` (the encoder output, or
        images) that ``encode`` turns into the encoder output at the start
        of the prefill: on the card the encoder is then part of the
        prefill's graph."""
        static["sampler"] = _check_sampler(static["sampler"])
        dev = params["decoder"]["classifier"]["weight"].device
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        # the positional table bounds total positions (start emb + tokens)
        static["max_len"] = min(max_len, self.max_len - 1)
        # the JAX package's two kernel-selecting switches, read per call:
        # DH_CROSS_PACK=<ng> runs decode cross-attention in K9 with ng
        # items per block (0 or unset: K2), DH_FUSED_SURVIVOR=1 runs the
        # survivor update in K10
        static.update(
            pack_items=int(os.environ.get("DH_CROSS_PACK", "0") or 0),
            fused_survivor=os.environ.get("DH_FUSED_SURVIVOR") == "1")
        first = next(iter(inputs.values()))
        num_items = (first[0] if isinstance(first, tuple) else first).shape[0]
        inputs = dict(inputs, caption=caption,
                      inv_t=inv_temperature(temperature, dev))
        return graphs.generate(
            lambda: self._program(params, encode, num_items, caption,
                                  model_group=model_group, **static),
            inputs, generator, compiled=compiled,
            key=lambda: graphs.graph_key(self, params, inputs,
                                         model_group=model_group, **static))

    def generate(self, params, images, generator=None, caption=None,
                 max_len=25, temperature=1.0, beam_size=10, top_k=50,
                 eos_index=EOS, greedy=False, sampler=None, compact=None,
                 canon=None, compiled=None):
        """Batched caption generation from NHWC images ``[B, H, W, 3]``
        (ImageNet-normalized; the encoder inside the call:
        :meth:`_from_images`); arguments as :meth:`generate_from_emb`."""
        return self._from_images(params, {"images": images}, dict(
            generator=generator, caption=caption, max_len=max_len,
            temperature=temperature, beam_size=beam_size, top_k=top_k,
            eos_index=eos_index, greedy=greedy, sampler=sampler,
            compact=compact, canon=canon, compiled=compiled))


@dataclasses.dataclass(frozen=True)
class CaptioningTransformer(CaptioningTransformerBase):
    """Cross-attention transformer captioner over spatial image features."""

    model_type = "captioning_transformer"
    cross_attention = True

    def forward(self, params, images, captions, lengths=None, train=False,
                gen=None, from_trunk=False, group=None, model_group=None):
        """Teacher-forced logits ``[bs, max(T+1, 49), num_tokens]`` of
        ``captions [bs, T]``, with the reference's pad-to-common-length
        quirk (``transformer_decoder_forward``: the loss slices the first
        T+1 positions); in train mode ``(logits, new_params)``, as
        :meth:`CaptioningLSTM.forward`; ``model_group`` as in
        :meth:`CaptioningTransformerBase.forward`."""
        return self._forward(
            params, image_encoder_apply(
                params["encoder"], images, spatial_features=True,
                dropout=self.enc_dropout, train=train, gen=gen,
                from_trunk=from_trunk, group=group), train,
            lambda dec, enc: tfm.transformer_decoder_forward(
                dec, captions, enc[1], enc[0], self.n_heads, self.pad_index,
                self.dec_dropout, train, gen, model_group))

    @torch.inference_mode()
    def encode(self, params, images):
        """NHWC images -> (global emb ``[bs, D]``, spatial emb
        ``[bs, 49, D]``); both can be cached per template."""
        return image_encoder_apply(params["encoder"], images,
                                   spatial_features=True)

    def _prefill_and_state(self, dec, enc, prefix, max_positions,
                           pad_to_tile=False, model_group=None):
        start_emb, spatial = enc
        # packed cross-attention (K9) reads a store padded to 8 rows;
        # decode_step widens the mask and K9 skips rows past cross_t_real
        cross = tfm.precompute_cross_attention(dec, spatial, pad_to_tile)
        # the reference masks encoder rows holding a zero
        enc_key_mask = ~(spatial != 0.0).all(dim=-1)
        logits, state = self._prefill(dec, start_emb, prefix, max_positions,
                                      cross, enc_key_mask, model_group)
        return logits, state, {"cross": cross, "enc_key_mask": enc_key_mask,
                               "cross_t_real": spatial.shape[1]}


@dataclasses.dataclass(frozen=True)
class CaptioningMLAMoE(_Captioner):
    """Decoder-only captioner on DeepSeek-V3's block (models/mla_moe.py):
    Kimi-VL-A3B-Instruct's language model, which captions an image from
    the ``prefix_len`` rows that its vision tower and projector give.
    ``generate_from_emb`` takes those rows (cached template features),
    prefills them, then beam-searches through :class:`BeamSearch`, the
    decode step's latent attention in K12 and the draws in K3 (V above
    K4's range: the classifier is a bf16 product before K3), replayed as
    CUDA graphs on the card (models/graphs.py) like the other captioners.

    ``n_held`` of the ``n_routed`` experts from ``held_first`` live here
    (one card's share under expert parallelism; every expert by default):
    the router keeps all its outputs and its ``experts_per_token``, and the
    layer adds its held experts' part. The router's weight and correction
    bias stay in f32 under a bf16 ``compute_dtype``; on the card the model
    runs in bf16 alone (another ``compute_dtype`` raises ``ValueError``).
    It has no checkpoint format of the JAX package, so it is not in
    ``MODEL_REGISTRY``.
    """

    num_tokens: int
    hid_dim: int = 2048
    n_layers: int = 27
    n_heads: int = 16
    qk_nope: int = 128
    qk_rope: int = 64
    v_dim: int = 128
    kv_rank: int = 512
    dense_width: int = 11264
    expert_width: int = 1408
    n_routed: int = 64
    n_held: int = 64
    held_first: int = 0
    experts_per_token: int = 6
    n_shared: int = 2
    first_dense: int = 1
    routed_scaling: float = 2.446
    rope_theta: float = 800000.0
    rms_eps: float = 1e-5
    prefix_len: int = 64
    compute_dtype: str = "float32"

    model_type = "captioning_mla_moe"

    def init(self, gen, device="cuda"):
        """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
        ``device``): ``{"decoder": ...}`` (models/mla_moe.py
        ``init_decoder``)."""
        return {"decoder": mla_moe.init_decoder(self, gen, device)}

    def _decoder_in_compute_dtype(self, params):
        """The decoder in the compute dtype, but each router's weight and
        correction bias, which route in f32."""
        dec = params["decoder"]
        cast = _cast(dec, self.compute_dtype)
        for layer, orig in zip(cast["layers"], dec["layers"]):
            if "gate" in layer["ffn"]:
                layer["ffn"] = dict(layer["ffn"], gate=orig["ffn"]["gate"])
        return cast

    @staticmethod
    def _shuffle_state(state, flat_branch, branch):
        """Survivor reorder: the latent rows stay in their slots; the
        ancestry table re-roots onto the surviving branch's history."""
        anc = state["anc"]
        return dict(state, anc=anc.gather(1, branch[:, :, None].expand_as(
            anc)))

    def _begin(self, params, prefix, inv_t, noise, *, max_len, beam_size,
               top_k, greedy, eos_index, sampler):
        """The prefill and the first draw: the started :class:`BeamSearch`
        of one call."""
        dec = self._decoder_in_compute_dtype(params)
        prefix = prefix.to(getattr(torch, self.compute_dtype))
        hidden, latent = mla_moe.prefill(self, dec, prefix)
        cls = dec["classifier"]
        logits = torch.nn.functional.linear(hidden, cls["weight"],
                                            cls["bias"])
        n, dev = prefix.shape[0], prefix.device
        rows = n * beam_size
        # generated position p of slot i; step s writes position s - 1
        state = {"prefix": latent, "s": 1,
                 "gen": [x.new_zeros((rows, max_len, x.shape[-1]))
                         for x in latent],
                 "anc": torch.arange(beam_size, device=dev)[
                     None, :, None].expand(n, beam_size, max_len).contiguous()}
        classifier = None
        if sampler == "pallas" and not greedy:
            classifier = (cls["weight"], cls["bias"])
        wabs = mla_moe.absorbed(self, dec)
        slots = torch.arange(beam_size, device=dev)
        positions = torch.arange(max_len, device=dev)

        def step(st, tokens):
            s, anc = st["s"], st["anc"]
            anc[:, :, s - 1] = slots
            bias = ancestry_bias(anc, (positions < s).expand(rows, max_len),
                                 max_len)
            out = mla_moe.decode_step(
                self, dec, wabs, L.embed(dec["tok_embedding"], tokens), s,
                st["prefix"], st["gen"], bias, beam_size)
            if classifier is None:
                out = L.linear(cls, out)
            return out, dict(st, s=s + 1)

        search = BeamSearch(
            step_fn=step, shuffle_fn=self._shuffle_state,
            beam_size=beam_size, top_k=top_k, inv_t=inv_t, max_len=max_len,
            greedy=greedy, sampler=sampler, classifier=classifier,
            eos_index=eos_index)
        return search.start(noise, state, logits)

    @torch.inference_mode()
    def generate_from_emb(self, params, enc, generator=None, caption=None,
                          max_len=25, temperature=1.0, beam_size=10,
                          top_k=50, eos_index=EOS, greedy=False,
                          sampler=None, compiled=None):
        """Batched generation from the image prefix rows ``enc`` ``[B,
        prefix_len, hid_dim]`` (or a 1-tuple of them); arguments and
        result as :meth:`CaptioningLSTM.generate_from_emb` (one segment of
        ``max_len`` steps, no phases and no compaction; ``caption`` is not
        taken)."""
        if caption is not None:
            raise ValueError("CaptioningMLAMoE takes no caption prefix")
        prefix = enc[0] if isinstance(enc, tuple) else enc
        if prefix.ndim != 3 or prefix.shape[1:] != (self.prefix_len,
                                                    self.hid_dim):
            raise ValueError(f"enc must be [B, {self.prefix_len}, "
                             f"{self.hid_dim}], got {tuple(prefix.shape)}")
        static = dict(max_len=max_len, beam_size=beam_size, top_k=top_k,
                      eos_index=eos_index, greedy=greedy,
                      sampler=_check_sampler(sampler))
        dev = params["decoder"]["classifier"]["weight"].device
        if dev.type == "cuda" and self.compute_dtype != "bfloat16":
            raise ValueError(f"CaptioningMLAMoE runs on the card in "
                             f"bfloat16 alone (K12 and the expert kernels "
                             f"take bf16), not {self.compute_dtype}")
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        inputs = {"enc": prefix, "inv_t": inv_temperature(temperature, dev)}
        program = graphs.Program(
            begin=lambda x, noise: self._begin(params, x["enc"], x["inv_t"],
                                               noise, **static),
            finish=lambda search: search.finish(),
            noise=noise_shapes(steps=max_len, num_items=prefix.shape[0],
                               beam_size=beam_size, top_k=top_k,
                               sampler=static["sampler"], greedy=greedy),
            device=dev)
        with profiling.span("model.generate"):
            return graphs.generate(
                lambda: program, inputs, generator, compiled=compiled,
                key=lambda: graphs.graph_key(self, params, inputs, **static))


MODEL_REGISTRY = {cls.model_type: cls for cls in (
    CaptioningLSTM, CaptioningLSTMWithLabels, CaptioningTransformerBase,
    CaptioningTransformer)}

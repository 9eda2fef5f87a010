"""The word-level cross-attention captioning transformer (inference).

Counterpart of ``CaptioningTransformer`` in
deephumor_tpu/models/caption_models.py: ResNet-50 spatial encoder ->
cross-attention transformer decoder, generating with batched beam search
over KV caches that are never reordered (ancestry tables select each
branch's history; see models/transformer.py).

The model is a frozen dataclass of hyperparameters; its parameters are a
nested dict of tensors (``init``, ``from_pretrained``) that the caller
places on a device. Generation runs where the parameters live: on a CUDA
device the decode path goes through the hand-written kernels, on the CPU
through their plain twins.
"""

import dataclasses
import math

import torch

from deephumor_tpu_torch import EOS
from deephumor_tpu_torch.convert.jax_params import params_from_jax
from deephumor_tpu_torch.models import layers as L
from deephumor_tpu_torch.models import transformer as tfm
from deephumor_tpu_torch.models.encoders import (image_encoder_apply,
                                                 image_encoder_init)
from deephumor_tpu_torch.models.sampling import beam_search
from deephumor_tpu_torch.utils.pytree import load_params, tree_map

__all__ = ["CaptioningTransformer"]

_SAMPLERS = ("exact", "pallas")


@dataclasses.dataclass(frozen=True)
class CaptioningTransformer:
    """Cross-attention transformer captioner over spatial image features.

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

    model_type = "captioning_transformer"

    def init(self, gen, device="cpu"):
        """Random parameters drawn from ``gen`` (a ``torch.Generator`` on
        ``device``)."""
        return {
            "encoder": image_encoder_init(gen, self.hid_dim, device),
            "decoder": tfm.transformer_decoder_init(
                gen, self.num_tokens, self.hid_dim, self.n_layers,
                self.pf_dim, self.max_len, device),
        }

    @classmethod
    def from_pretrained(cls, path, device="cpu"):
        """Loads a ``.npz`` + ``.json`` checkpoint saved by the JAX
        package's ``save``; returns ``(model, params)``."""
        tree, hp = load_params(path)
        hp = dict(hp or {})
        model_type = hp.pop("model_type", cls.model_type)
        if model_type != cls.model_type:
            raise ValueError(f"checkpoint holds a {model_type!r} model")
        params = tree_map(lambda t: t.to(device), params_from_jax(tree))
        return cls(**hp), params

    @torch.inference_mode()
    def encode(self, params, images):
        """NHWC images -> (global emb ``[bs, D]``, spatial emb
        ``[bs, 49, D]``); both can be cached per template."""
        return image_encoder_apply(params["encoder"], images,
                                   spatial_features=True)

    def _prefill_and_state(self, dec, enc, prefix, max_positions):
        start_emb, spatial = enc
        bs = start_emb.shape[0]
        scale = math.sqrt(self.hid_dim)
        cache = tfm.init_cache(dec, bs, max_positions, dtype=start_emb.dtype)
        valid = torch.zeros((bs, max_positions), dtype=torch.bool,
                            device=start_emb.device)
        valid[:, 0] = True
        cross = tfm.precompute_cross_attention(dec, spatial)
        # the reference masks encoder rows holding a zero
        enc_key_mask = ~(spatial != 0.0).all(dim=-1)
        logits, cache = tfm.decode_step(
            dec, start_emb / scale, 0, cache, valid, self.n_heads, cross,
            enc_key_mask)
        pos = 1
        for i in range(0 if prefix is None else prefix.shape[1]):
            tok = prefix[:, i]
            valid[:, pos] = tok != self.pad_index
            emb = L.embed(dec["tok_embedding"], tok) / scale
            logits, cache = tfm.decode_step(
                dec, emb, pos, cache, valid, self.n_heads, cross,
                enc_key_mask)
            pos += 1
        state = {"cache": cache, "valid": valid, "pos": pos}
        return logits, state, {"cross": cross, "enc_key_mask": enc_key_mask}

    def _make_step(self, dec, consts, p_eff, return_hidden):
        scale = math.sqrt(self.hid_dim)

        def step(state, tokens):
            pos, valid, anc = state["pos"], state["valid"], state["anc"]
            valid[:, pos] = tokens != self.pad_index
            # this step's K/V land in the branch's own physical slot
            anc[:, :, pos] = torch.arange(anc.shape[1], device=anc.device)
            emb = L.embed(dec["tok_embedding"], tokens) / scale
            out, cache = tfm.decode_step(
                dec, emb, pos, state["cache"], valid, self.n_heads,
                consts["cross"], consts["enc_key_mask"], anc=anc,
                p_eff=p_eff, return_hidden=return_hidden)
            return out, dict(state, cache=cache, pos=pos + 1)

        return step

    @staticmethod
    def _shuffle_state(state, flat_branch, branch):
        """Survivor reorder without touching the KV caches: validity
        follows the branch, the ancestry table re-roots onto the surviving
        branch's history."""
        anc = state["anc"]
        return dict(state, valid=state["valid"][flat_branch],
                    anc=anc.gather(1, branch[:, :, None].expand_as(anc)))

    def _generate_impl(self, params, enc, gen, caption, temperature, *,
                       max_len, beam_size, top_k, greedy, eos_index,
                       sampler):
        dec = params["decoder"]
        dt = getattr(torch, self.compute_dtype)
        if dt != torch.float32:
            dec = tree_map(lambda t: t.to(dt), dec)
            enc = tuple(e.to(dt) for e in enc)
        prefix_len = 0 if caption is None else caption.shape[1]
        max_positions = max_len + 1
        logits, state, consts = self._prefill_and_state(
            dec, enc, caption, max_positions)
        # decoder state is tiled per beam (item-major rows); the
        # cross-attention K/V stay per item
        state["cache"] = [{k: v.repeat_interleave(beam_size, 0)
                           for k, v in layer.items()}
                          for layer in state["cache"]]
        state["valid"] = state["valid"].repeat_interleave(beam_size, 0)
        num_items = logits.shape[0]
        # every beam slot holds its own copy of the prefill cache
        state["anc"] = torch.arange(beam_size, device=logits.device)[
            None, :, None].expand(num_items, beam_size,
                                  max_positions).contiguous()
        classifier = None
        if sampler == "pallas" and not greedy:
            cls = dec["classifier"]
            classifier = (cls["weight"], cls["bias"])
        # phase ladder: the attention kernel reads only the first p_eff
        # cache positions, which grow with the decode position (step s
        # needs p_eff >= prefix_len + s + 1); the last phase reads only
        # through the last written position
        p_cache = -(-max_positions // 8) * 8
        steps = max_len - prefix_len
        pes = [pe for pe in range(16, p_cache, 8)
               if 1 <= pe - prefix_len - 1 < steps - 1]
        p_last = min(p_cache, -(-(prefix_len + steps) // 8) * 8)
        phases = [(pe - prefix_len - 1,
                   self._make_step(dec, consts, pe, classifier is not None))
                  for pe in pes]
        phases.append((steps - 1, self._make_step(
            dec, consts, p_last, classifier is not None)))
        return beam_search(
            gen, state, logits, shuffle_fn=self._shuffle_state,
            phases=phases, beam_size=beam_size, top_k=top_k,
            temperature=temperature, max_len=max_len, prefix=caption,
            prefix_len=prefix_len, greedy=greedy, sampler=sampler,
            classifier=classifier, eos_index=eos_index,
            pad_index=self.pad_index)

    @torch.inference_mode()
    def generate_from_emb(self, params, enc, generator=None, caption=None,
                          max_len=25, temperature=1.0, beam_size=10,
                          top_k=50, eos_index=EOS, greedy=False,
                          sampler=None):
        """Batched generation from (possibly cached) ``encode`` output.

        Args:
            enc: ``(global emb [B, D], spatial emb [B, T, D])``.
            generator: ``torch.Generator`` on the parameters' device
                (default: seeded with 0).
            caption: optional ``[B, prefix_len]`` fixed first tokens.
            sampler: "exact" (default; sorted f32 top-k) or "pallas" (the
                K3 kernel; the serving path).

        Returns:
            dict with ``sequences [B, beam, max_len]``, ``scores``,
            ``chosen [B, max_len]`` and ``ended``.
        """
        sampler = sampler or "exact"
        if sampler not in _SAMPLERS:
            raise ValueError(f"sampler must be one of {_SAMPLERS}")
        if generator is None:
            generator = torch.Generator(enc[0].device).manual_seed(0)
        # the positional table bounds total positions (start emb + tokens)
        max_len = min(max_len, self.max_len - 1)
        return self._generate_impl(
            params, enc, generator, caption, temperature, max_len=max_len,
            beam_size=beam_size, top_k=top_k, greedy=greedy,
            eos_index=eos_index, sampler=sampler)

    def generate(self, params, images, generator=None, caption=None,
                 max_len=25, temperature=1.0, beam_size=10, top_k=50,
                 eos_index=EOS, greedy=False, sampler=None):
        """Batched caption generation from NHWC images ``[B, H, W, 3]``
        (ImageNet-normalized); arguments as :meth:`generate_from_emb`."""
        return self.generate_from_emb(
            params, self.encode(params, images), generator=generator,
            caption=caption, max_len=max_len, temperature=temperature,
            beam_size=beam_size, top_k=top_k, eos_index=eos_index,
            greedy=greedy, sampler=sampler)

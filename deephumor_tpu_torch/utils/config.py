"""Experiment configuration: the model's hyperparameters with training and
sampling settings, saved as JSON.

Counterpart of deephumor_tpu/utils/config.py, with the same fields and
defaults, so a file saved by either package loads in the other and builds
the same model.
"""

import dataclasses
import json

__all__ = ["TrainConfig", "SamplingConfig", "ExperimentConfig"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    clip_norm: float = 3.0
    weight_decay: float = 0.0
    n_epochs: int = 50
    batch_size: int = 256
    max_caption_len: int = 32
    max_label_len: int = 8
    seed: int = 0
    log_grad_norm: bool = False


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Generation settings; the reference demo's word and char presets are
    the two classmethods."""

    max_len: int = 32
    beam_size: int = 10
    top_k: int = 70
    temperature: float = 1.0
    sampler: str = "exact"
    greedy: bool = False

    @classmethod
    def word_default(cls):
        return cls(max_len=32, beam_size=10, top_k=70, temperature=1.0)

    @classmethod
    def char_default(cls):
        return cls(max_len=128, beam_size=7, top_k=50, temperature=1.1)

    def generate_kwargs(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """Model, training and sampling settings in one JSON-saved record."""

    model_type: str
    model_hp: dict
    train: TrainConfig = TrainConfig()
    sampling: SamplingConfig = SamplingConfig()
    title: str = "experiment"

    def build_model(self):
        """The model of ``MODEL_REGISTRY[model_type]`` with the stored
        hyperparameters."""
        from deephumor_tpu_torch.models import MODEL_REGISTRY

        return MODEL_REGISTRY[self.model_type](**self.model_hp)

    def save(self, path):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            raw = json.load(f)
        raw["train"] = TrainConfig(**raw.get("train", {}))
        raw["sampling"] = SamplingConfig(**raw.get("sampling", {}))
        return cls(**raw)

    @classmethod
    def from_model(cls, model, **kwargs):
        """A config of a model's type and hyperparameters (``hp()``)."""
        return cls(model_type=model.model_type, model_hp=model.hp(),
                   **kwargs)

"""Small cells for the CPU tests: the cells' kinds and metrics at widths
that a test run holds, f32."""

from perfbench.core import spec

WORD = {"model": "CaptioningTransformer", "num_tokens": 64, "hid_dim": 32,
        "n_layers": 2, "n_heads": 2, "pf_dim": 64, "max_len": 50,
        "encoder_rows": 5, "compute_dtype": "float32", "enc_dropout": 0.3,
        "dec_dropout": 0.1,
        "generation": {"max_len": 10, "beam_size": 3, "top_k": 8,
                       "temperature": 1.0, "sampler": "pallas"},
        "assumed": {"eos_bias": 2.0}, "name": "tiny"}
CHAR = dict(WORD, generation={"max_len": 12, "beam_size": 4, "top_k": 6,
                              "temperature": 1.1, "sampler": "pallas"},
            assumed={"eos_bias": 0.5})
OFFLINE = {"kind": "offline", "items_per_call": 8, "templates": 10,
           "popularity": {"law": "uniform"}, "schedule_calls": 4,
           "check_items": 8, "name": "offline_8"}
SERVE = {"kind": "serve", "rate": 200, "arrivals": {"process": "poisson"},
         "templates": 6, "popularity": {"law": "zipf", "s": 1.1},
         "image_side": 32, "check_items": 16, "name": "serve_40",
         "batcher": {"max_batch": 16, "max_wait_ms": 8, "buckets": "auto"}}
TRAIN = {"kind": "train", "batch": 16, "caption_tokens": 9,
         "words_median": 4, "words_sigma": 0.45, "templates": 10,
         "pool_batches": 8, "warm_steps": 4,
         "learning_rate": 1e-3, "clip_norm": 3.0, "name": "train_16"}
TRAIN_CFG = dict(WORD, encoder_rows=49)


def cell(name, chips=1):
    """The cell ``name`` of BENCHMARK.json with its metrics, at the small
    configuration and traffic of its kind."""
    real = spec.cell(name)
    kind = real.traffic["kind"]
    cfg, traffic = {"offline": (WORD if real.config["name"] == "word"
                                else CHAR, OFFLINE),
                    "serve": (WORD, SERVE),
                    "train": (TRAIN_CFG, TRAIN)}[kind]
    return spec.Cell(name, chips if kind == "train" else 1, dict(cfg),
                     dict(traffic), real.end_to_end, real.per_layer)

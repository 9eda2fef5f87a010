"""HTTP meme-caption server over the dynamic batcher.

Counterpart of examples/serve.py. Concurrent requests coalesce into
padded device batches (``deephumor_tpu_torch.serving.DynamicBatcher``),
so the endpoint rides the decode path's large-batch throughput while the
added latency stays within ``--max-wait-ms``.

    # synthetic mode (a small random model, 3 random templates):
    python -m deephumor_tpu_torch.serve --synthetic --port 8080

    # a checkpoint (.npz + .json of either package's ``save``):
    python -m deephumor_tpu_torch.serve --ckpt runs/word.best \\
        --vocab vocab.txt --templates data/memes900k --port 8080

    GET /caption?template=<id>              -> text/plain caption
    GET /captions?template=<a>&template=<b> -> JSON, one entry per id
    GET /meme?template=<id>                 -> image/png (needs Pillow)
    GET /healthz                            -> JSON: ok + batcher counters

The server runs on the card unless ``--device cpu`` is given. ``serve``
takes a ready pipeline and its generate settings, for callers that build
their own model.
"""

import argparse
import importlib.util
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

__all__ = ["build_synthetic", "build_real", "make_handler", "serve", "main"]

RESULT_TIMEOUT_S = 120


def _have_pil():
    return importlib.util.find_spec("PIL") is not None


def build_synthetic(device="cuda"):
    """A small random CaptioningTransformerBase over a 126-token
    vocabulary and three random templates (with images to render when
    Pillow is installed); returns ``(pipeline, generate settings)``."""
    from deephumor_tpu_torch.data.vocab import Vocab
    from deephumor_tpu_torch.models import CaptioningTransformerBase
    from deephumor_tpu_torch.pipeline import MemeGenerationPipeline

    vocab = Vocab([f"word{i}" for i in range(120)])
    model = CaptioningTransformerBase(
        num_tokens=len(vocab), hid_dim=32, n_layers=2, n_heads=2, pf_dim=64,
        max_len=18, enc_dropout=0.0, dec_dropout=0.0)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    pipe = MemeGenerationPipeline(model, params, vocab)
    rng = np.random.default_rng(0)
    ids = ["one", "two", "three"]
    images = rng.normal(size=(3, 224, 224, 3)).astype(np.float32)
    pils = None
    if _have_pil():
        from PIL import Image

        pils = [Image.fromarray(rng.integers(0, 255, (300, 400, 3),
                                             dtype=np.uint8))
                for _ in ids]
    pipe.add_templates(ids, images, pil_images=pils)
    return pipe, dict(max_len=12, beam_size=3, top_k=32)


def build_real(ckpt, vocab_path, data_dir, num_templates, device="cuda"):
    """The checkpoint's model over a memes900k-style directory's
    templates (their images preprocessed with PIL); returns
    ``(pipeline, generate settings)``."""
    from PIL import Image

    from deephumor_tpu_torch.data.datasets import MemeDataset
    from deephumor_tpu_torch.data.tokenizers import WordPunctTokenizer
    from deephumor_tpu_torch.data.vocab import Vocab
    from deephumor_tpu_torch.models import MODEL_REGISTRY
    from deephumor_tpu_torch.pipeline import MemeGenerationPipeline
    from deephumor_tpu_torch.utils.pytree import load_params

    _, hp = load_params(ckpt)
    model_type = (hp or {}).get("model_type", "captioning_transformer")
    model, params = MODEL_REGISTRY[model_type].from_pretrained(
        ckpt, device=device)
    vocab = Vocab.load(vocab_path)
    ds = MemeDataset(data_dir, vocab, WordPunctTokenizer(), split="train",
                     num_classes=num_templates)
    pipe = MemeGenerationPipeline(model, params, vocab)
    ids = list(ds.images)
    pils = [Image.open(ds.templates[t]) for t in ids]
    pipe.add_templates(ids, np.stack([ds.images[t] for t in ids]),
                       pil_images=pils)
    return pipe, dict(max_len=32, beam_size=5, top_k=64)


def _error(tid, e):
    if isinstance(e, KeyError):
        return {"template": tid, "error": "unknown template",
                "error_type": "KeyError"}
    return {"template": tid, "error": f"{type(e).__name__}: {e}",
            "error_type": type(e).__name__}


def make_handler(caption_srv, meme_srv):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code, body, ctype="text/plain"):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            tid = (q.get("template") or [None])[0]
            try:
                if url.path == "/healthz":
                    self._send(200, json.dumps({
                        "ok": True,
                        "batches": caption_srv.batches_dispatched
                        + meme_srv.batches_dispatched,
                        "requests": caption_srv.requests_served
                        + meme_srv.requests_served,
                    }), "application/json")
                elif url.path == "/caption" and tid:
                    self._send(200, caption_srv.submit(tid).result(
                        RESULT_TIMEOUT_S))
                elif url.path == "/captions" and q.get("template"):
                    # one queue hop for the whole list; each id's failure,
                    # whatever it is, lands in its own entry
                    futs = caption_srv.submit_many(q["template"])
                    out = []
                    for t, f in zip(q["template"], futs):
                        try:
                            out.append({"template": t, "caption":
                                        f.result(RESULT_TIMEOUT_S)})
                        except Exception as e:  # noqa: BLE001
                            out.append(_error(t, e))
                    self._send(200, json.dumps(out), "application/json")
                elif url.path == "/meme" and tid:
                    if not _have_pil():
                        self._send(501, "/meme renders with Pillow, which "
                                        "is not installed here; /caption "
                                        "and /captions serve without it")
                        return
                    text, img = meme_srv.submit(tid).result(RESULT_TIMEOUT_S)
                    buf = io.BytesIO()
                    img.save(buf, "PNG")
                    self._send(200, buf.getvalue(), "image/png")
                else:
                    self._send(404, "unknown route or missing ?template=")
            except KeyError:
                self._send(404, f"unknown template {tid!r}")
            except Exception as e:  # noqa: BLE001 — per-request isolation
                self._send(500, f"{type(e).__name__}: {e}")

    return Handler


def serve(pipe, gen, *, host="127.0.0.1", port=8080, max_batch=256,
          max_wait_ms=8.0, buckets="auto", ready_event=None):
    """Serves ``pipe`` with the generate settings ``gen`` until the
    server is shut down: a caption batcher (seed 0) and a meme batcher
    (seed 1, rendering), the caption batcher warmed at every bucket.
    ``ready_event`` (a ``threading.Event``) is set once the socket
    listens, with ``.httpd``, ``.caption_srv`` and ``.meme_srv`` attached
    (``port=0`` picks a free port: read ``httpd.server_address``)."""
    from deephumor_tpu_torch.serving import DynamicBatcher

    caption_srv = DynamicBatcher(pipe, max_batch=max_batch,
                                 max_wait_ms=max_wait_ms, buckets=buckets,
                                 seed=0, **gen)
    meme_srv = DynamicBatcher(pipe, max_batch=max_batch,
                              max_wait_ms=max_wait_ms, render=True,
                              buckets=buckets, seed=1, **gen)
    httpd = None
    try:
        caption_srv.warmup()
        httpd = ThreadingHTTPServer((host, port),
                                    make_handler(caption_srv, meme_srv))
        print(f"serving on http://{host}:{httpd.server_address[1]} "
              f"(templates: {len(pipe._row)}, device: {pipe.device})",
              flush=True)
        if ready_event is not None:
            ready_event.httpd = httpd
            ready_event.caption_srv = caption_srv
            ready_event.meme_srv = meme_srv
            ready_event.set()
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if httpd is not None:
            httpd.server_close()
        caption_srv.close()
        meme_srv.close()


def main(argv=None, ready_event=None):
    ap = argparse.ArgumentParser(
        prog="python -m deephumor_tpu_torch.serve",
        description="HTTP meme-caption server")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--ckpt")
    ap.add_argument("--vocab")
    ap.add_argument("--templates", help="memes900k-style data dir")
    ap.add_argument("--num-templates", type=int, default=300)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=8.0)
    ap.add_argument("--buckets", default="auto",
                    help='"auto" (default), "none" (always pad to '
                         "max-batch), or comma-separated sizes, e.g. "
                         '"32,128"')
    args = ap.parse_args(argv)
    if args.buckets == "none":
        buckets = None
    elif args.buckets == "auto":
        buckets = "auto"
    else:
        try:
            buckets = [int(x) for x in args.buckets.split(",")]
        except ValueError:
            ap.error(f"--buckets {args.buckets!r}: expected 'auto', "
                     "'none', or comma-separated ints like '32,128'")
    if args.synthetic:
        pipe, gen = build_synthetic(args.device)
    else:
        if not (args.ckpt and args.vocab and args.templates):
            ap.error("--ckpt/--vocab/--templates required without "
                     "--synthetic")
        pipe, gen = build_real(args.ckpt, args.vocab, args.templates,
                               args.num_templates, args.device)
    serve(pipe, gen, port=args.port, max_batch=args.max_batch,
          max_wait_ms=args.max_wait_ms, buckets=buckets,
          ready_event=ready_event)


if __name__ == "__main__":
    main()

"""TTS serving CLI: a dynamic-batching HTTP server over the port's pipeline
(CUDA by default).

Usage:
  python -m zipvoice_tpu_torch.bin.serve --model-dir exp/zipvoice \\
      --vocoder-path vocos/pytorch_model.bin --port 8080 --warmup

  curl -X POST localhost:8080/synthesize -d '{"text": "...",
      "prompt_text": "...", "prompt_wav_b64": "<base64 wav>"}' > out.wav

``--warmup`` captures the serving graphs (one request and a batch of
``--max-batch``) before the listener opens.  ``--device cpu`` serves from
the CPU, eagerly.
"""

from __future__ import annotations

import argparse
import logging
import time

from zipvoice_tpu_torch.bin.infer_zipvoice import _NOT_PORTED


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-name", type=str, default="zipvoice",
                   choices=["zipvoice", "zipvoice_distill"])
    p.add_argument("--model-dir", type=str, default=None)
    p.add_argument("--checkpoint-name", type=str, default="model.pt")
    p.add_argument("--vocoder-path", type=str, default=None)
    p.add_argument("--tokenizer", type=str, default="emilia")
    p.add_argument("--lang", type=str, default="en-us")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=30.0)
    p.add_argument("--num-step", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--feat-scale", type=float, default=0.1)
    p.add_argument("--feat-bias", type=float, default=0.0)
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--quantize", type=str, default=None,
                   choices=["int8", "int8-dynamic"],
                   help="int8 linear layers: weight-only, or dynamic "
                        "(per-row activation scales, int8 x int8 -> int32)")
    p.add_argument("--warmup", action="store_true",
                   help="capture the serving graphs before listening")
    p.add_argument("--allow-custom-sampling", action="store_true",
                   help="accept per-request num_step/guidance/t_shift "
                        "(each distinct tuple captures new graphs; off by "
                        "default to keep clients from driving captures)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Device to run on")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    server = build_server(args)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


def build_server(args):
    """The TTSServer the parsed arguments describe, its pipeline warmed
    when ``--warmup`` is given; not yet serving."""
    if args.model_dir is None:
        raise SystemExit(f"downloading a model {_NOT_PORTED}: pass --model-dir")

    from zipvoice_tpu_torch.bin.infer_zipvoice import build_pipeline
    from zipvoice_tpu_torch.serve.server import TTSServer

    # build_pipeline resolves --num-step/--guidance-scale against the
    # model's defaults
    pipeline, num_step, guidance_scale = build_pipeline(args)

    if args.warmup:
        logging.info("capturing the serving graphs (one request and a batch of %d)...",
                     args.max_batch)
        t0 = time.monotonic()
        pipeline.warmup(num_step=num_step, guidance_scale=guidance_scale,
                        batch_sizes=(args.max_batch,))
        logging.info("warmup done: %.1f s, %d graphs captured",
                     time.monotonic() - t0, pipeline.captures)

    return TTSServer(
        pipeline, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        num_step=num_step, guidance_scale=guidance_scale,
        allow_custom_sampling=args.allow_custom_sampling,
    )


if __name__ == "__main__":
    main()

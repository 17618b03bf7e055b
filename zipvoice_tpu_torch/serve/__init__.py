"""Serving layer: an HTTP server with dynamic request batching over the
pipeline's captured programs (serve/server.py, bin/serve.py)."""

from zipvoice_tpu_torch.serve.server import DynamicBatcher, TTSServer  # noqa: F401

"""A stand-in for the reference ``zipvoice`` package, for the tests of
``zipvoice_tpu_torch/eval/parity.py`` and for ``chip_smoke.py``: torch only,
with the import paths and methods that both packages' parity harnesses call,
built on the port's own modules on the CPU in f32.  It is not the reference:
it lets the harness run end to end, and the JAX package's ``run_parity``,
pointed at it, holds it to the API the reference offers.

``PATH`` is the directory to pass as ``reference_path``; ``unload()`` takes
its ``zipvoice`` modules out of ``sys.modules`` and its path off
``sys.path`` after a use, so that nothing leaks into other tests run by the
same process."""

import sys
from pathlib import Path

PATH = Path(__file__).resolve().parent


def unload():
    for name in [m for m in sys.modules if m == "zipvoice" or m.startswith("zipvoice.")]:
        del sys.modules[name]
    while str(PATH) in sys.path:
        sys.path.remove(str(PATH))

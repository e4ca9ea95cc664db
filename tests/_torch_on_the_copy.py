"""A reference suite's source with the port's copies in place of the JAX
package's modules, for the ``tests/test_torch_*.py`` files that run it
again on the copy: ``repro.core``, ``repro.sched``, ``repro.obs``,
``repro.fleet``, ``repro.chaos`` and the serving plane's
``repro.serve.{kv,plane,requests,stats}`` become their ``repro_torch``
counterparts; every other import (the JAX engine, the
models) is left as it is."""
import re
from pathlib import Path

COPIED = re.compile(
    r"\brepro\.(core|sched|obs|fleet|chaos|"
    r"serve\.(?:kv|plane|requests|stats))\b")


def on_the_copy(name: str):
    """``tests/<name>`` compiled with the copies' names put in: exec it
    into a test module's namespace to collect every case there."""
    path = Path(__file__).with_name(name)
    return compile(COPIED.sub(r"repro_torch.\1", path.read_text()),
                   str(path), "exec")

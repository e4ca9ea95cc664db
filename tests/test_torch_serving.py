"""The reference's suite ``tests/test_serving.py`` run on the port's copy of
the planes: its source, unchanged but for the copied modules' names
(``_torch_on_the_copy.py``), executed into this module, so every case
(and marker) that passes on the JAX package's modules runs again on
``repro_torch``'s.

All but ``TestServeEngineCrossCheck`` (``tests/test_serving.py:462-521``),
which is left out: it builds the JAX model and runs the JAX
``ServeEngine`` on the CPU, and its calibration constant is that engine's
on a CPU.  Its counterpart on the card is chip_smoke's ``tenants`` phase,
which prints the planes' analytic decode rate for qwen2_0_5b beside the
port's measured tokens/s on the H100 and their ratio."""
from _torch_on_the_copy import on_the_copy

exec(on_the_copy("test_serving.py"))
del TestServeEngineCrossCheck  # noqa: F821 (defined by the exec)

"""The reference's suite ``tests/test_fleet.py`` run on the port's copy of
the planes: its source, unchanged but for the copied modules' names
(``_torch_on_the_copy.py``), executed into this module, so every case
(and marker) that passes on the JAX package's modules runs again on
``repro_torch``'s."""
from _torch_on_the_copy import on_the_copy

exec(on_the_copy("test_fleet.py"))

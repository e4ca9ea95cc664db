"""The reference's suite ``tests/test_chaos.py`` run on the port's copy of
the planes: its source, unchanged but for the copied modules' names
(``_torch_on_the_copy.py``), executed into this module, so every case
(and marker) that passes on the JAX package's modules runs again on
``repro_torch``'s.  ``TestMarkRepaired::test_uvm_fail_repair_census``
fails here as it fails on the reference: it calls
``UVMAllocator.allocated_cores``, which ``core/baselines.py`` (copied byte
for byte) does not define."""
from _torch_on_the_copy import on_the_copy

exec(on_the_copy("test_chaos.py"))

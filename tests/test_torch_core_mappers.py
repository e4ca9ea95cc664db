"""The reference's suite ``tests/test_mappers.py`` run on the
port's copy of the vNPU core: its source, unchanged but for
``repro_torch.core`` put in place of ``repro.core``, executed into this
module, so every case (and marker) that passes on ``repro.core`` runs
again on ``repro_torch.core``."""
from pathlib import Path

_REF = Path(__file__).with_name("test_mappers.py")
exec(compile(_REF.read_text().replace("repro.core", "repro_torch.core"),
             str(_REF), "exec"))

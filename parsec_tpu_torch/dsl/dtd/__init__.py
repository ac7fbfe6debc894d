"""DTD front-end: dynamic task discovery (insert_task).

reference: parsec/interfaces/dtd/ — see insert.py in this package.
"""

from parsec_tpu_torch.dsl.dtd.insert import (  # noqa: F401
    AFFINITY, DONT_TRACK, INOUT, INPUT, OUTPUT, PULLIN, PUSHOUT, SCRATCH,
    VALUE, DTDTaskClass, DTDTaskpool, DTDTile, Region)

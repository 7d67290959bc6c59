"""Device ms an image of the kernels launched under vision.proposal_mlp: a
hash proposal field's layers, trunc_exp and mask (fields/nerfacto.py's
HashDensityField), both proposal fields, from the traced slice. A program
without hash proposal fields has no such span: None."""

from portbench.core.spans import device_ms

SOURCE = "program_span"


def read(rec):
    return device_ms(rec, "vision.proposal_mlp") if "pixels" in rec.work else None

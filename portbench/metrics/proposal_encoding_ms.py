"""Device ms an image of the kernels launched under
vision.proposal_encoding: a hash proposal field's grid
(fields/nerfacto.py's HashDensityField, the hash-encoding kernel), both
proposal fields, from the traced slice. A program without hash proposal
fields has no such span: None."""

from portbench.core.spans import device_ms

SOURCE = "program_span"


def read(rec):
    return device_ms(rec, "vision.proposal_encoding") if "pixels" in rec.work else None

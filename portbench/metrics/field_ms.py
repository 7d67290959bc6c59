"""Device ms a unit of the kernels launched under the field's span, from
the traced slice: a request's acoustic field over every STFT frame of its
RIRs (rir.field: the query batch and fields/acoustic.py), or an image's
main radiance field (vision.field: fields/nerfacto.py's NerfactoField)."""

from portbench.core.spans import by_unit, device_ms

SOURCE = "program_span"


def read(rec):
    name = by_unit(rec, "rir.field", "vision.field")
    return None if name is None else device_ms(rec, name)

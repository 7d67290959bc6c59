"""Device ms an image of the kernels launched under vision.proposal: the
two proposal fields (fields/nerfacto.py's ProposalDensityField, the PE+MLP
kernel) and their transmittance weights, from the traced slice."""

from portbench.core.spans import device_ms

SOURCE = "program_span"


def read(rec):
    return device_ms(rec, "vision.proposal") if "pixels" in rec.work else None

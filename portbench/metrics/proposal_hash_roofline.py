"""% of the least time of an image's proposal hash encodings in the device
ms under vision.proposal_encoding. The least time is
`proposal_hash_bound_ms` (both hash proposal fields' samples of the
configuration; ops/cuda/hash_encoding.py) held to the points the program
counted through its proposal fields an image (counters
image.proposal_points / image.requests, against the unit's
`proposal_points`). The bound leaves out the table rows read, so the share
is a floor. None where the unit counts no such work or the program has no
such span or counter."""

from portbench.core.spans import counter, device_ms

SOURCE = "program_span"


def read(rec):
    bound, want = rec.work.get("proposal_hash_bound_ms"), rec.work.get("proposal_points")
    ms = device_ms(rec, "vision.proposal_encoding")
    points, images = counter("image.proposal_points"), counter("image.requests")
    if bound is None or not want or ms is None or not points or not images:
        return None
    return 100.0 * bound * (points / images / want) / ms

"""shade_roofline: the shading kernel S1's least time over its device time,
in % (layer: kernels). The device time is shade_device_ms: the kernels
launched inside the program's bounce.shade spans in the span frame. The
least time moves each shaded lane's bytes once at the HBM peak
(harness/roofline.py): what S1 must read and write of a live lane
(chameleonrt_tpu_torch/csrc/shade.cu), whatever kernel implements the
shading, times the program's lanes.shaded counter a frame."""

from benchmark.harness.roofline import DEFAULT_CARD, PEAKS
from benchmark.harness.spans import span_record

# a live lane's bytes (csrc/shade.cu's count): 57 of lane state in, 4 more (its hit instance) where
# the scene has instances, and 91 out; the shade rows and materials, which the L2 holds, not counted
LANE_IN_BYTES = 57
INSTANCE_BYTES = 4
LANE_OUT_BYTES = 91


def least_bytes(lanes: float, instanced: bool = True) -> float:
    return lanes * (LANE_IN_BYTES + (INSTANCE_BYTES if instanced else 0) + LANE_OUT_BYTES)


def read(record):
    spans = span_record(record)
    if not spans:
        return None
    ms = spans["device_ms"].get("bounce.shade")
    lanes = spans["counts"].get("lanes.shaded")
    if not ms or not lanes:
        return None
    peak = PEAKS.get(record.get("card"), PEAKS[DEFAULT_CARD])["hbm_bytes_per_s"]
    return 100.0 * least_bytes(lanes) / peak / (ms * 1e-3)

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): what a roofline share is taken against."""

#: HBM3 bandwidth, bytes a second
HBM_BYTES_PER_S = 3.35e12

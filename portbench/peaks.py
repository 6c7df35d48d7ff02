"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives. NVIDIA H100 SXM data sheet, at
the full 700 W power limit: HBM3 3.35 TB/s."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}

"""The API layer's own time an encode call: `SprintzCodec.compress`,
`encoder.compress` and `encoder.compress_with_layout`, less the other
layers' functions they call (the upload, the device pass, the plan, the
assembly): numpy glue and the downloads of the device pass's outputs
(`.cpu()`). In traced runs the device pass's span closes only once the
card has finished its work (`SYNC`), so the wait for FIRE's kernel lands
there and not in the first download."""

E = "sprintz_tpu_torch.encoder."
LAYER = "API"
SOURCE = "program_span"
MOVES = "encode_GBps"
ENTRY = "sprintz_tpu_torch.api.SprintzCodec.compress"
OWN = (ENTRY, E + "compress", E + "compress_with_layout")
WRAPS = OWN + (E + "upload_rows", E + "encode_device", E + "build_plan",
               E + "assemble_stream")
SYNC = (E + "encode_device",)


def read(r):
    return r.self_ms(ENTRY, OWN) if r.has(WRAPS) else None

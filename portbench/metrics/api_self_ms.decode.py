"""The API layer's own time a decode call: `SprintzCodec.decompress` and
`decoder.decompress`, less the other layers' functions they call (the
walk, the gather, the upload, the device pass, the download). Mostly the
numpy concatenation of the values and the verbatim tail."""

D = "sprintz_tpu_torch.decoder."
LAYER = "API"
SOURCE = "program_span"
MOVES = "decode_GBps"
ENTRY = "sprintz_tpu_torch.api.SprintzCodec.decompress"
OWN = (ENTRY, D + "decompress")
WRAPS = OWN + (D + "walk_headers", D + "gather_payloads", D + "upload_payload",
               D + "decode_device", D + "download_values")


def read(r):
    return r.self_ms(ENTRY, OWN) if r.has(WRAPS) else None

"""Entries: what a mix calls, one module an entry, found by the name in
the traffic file (``loop.load_traffic``)."""

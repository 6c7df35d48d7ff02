"""Loops: how a mix's client calls, one module a loop, found by the
name in the traffic file (``loop.load_traffic``)."""

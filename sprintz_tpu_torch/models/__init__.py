"""Models of the port: the forecasters (delta family, FIRE), the online
subsystem, and the filter-bank search (``learning``)."""

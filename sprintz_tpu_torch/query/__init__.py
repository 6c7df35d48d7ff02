"""Query pushdown: reductions evaluated over compressed streams on the card."""

from .pushdown import Operation, QueryParams, QueryResult, query  # noqa: F401

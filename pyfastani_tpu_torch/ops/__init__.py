"""The query path's device operations, one module per stage."""

"""The reference's positional encodings, one module a ``pos_enc`` setting,
each with ``in_dim(train)`` (the MLP's input width) and ``encode(x, train)``
(the MLP's input at scaled (P, 3) positions). A cell whose ``pos_enc`` has
no module here is refused (portbench/reference/steps.py::unmodelled)."""

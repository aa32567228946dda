"""The reference's positional encodings, one module a ``pos_enc`` setting.
A cell whose ``pos_enc`` has no module here is refused
(portbench/reference/steps.py::unmodelled). Each module has:

- ``in_dim(train)``: the MLP's input width;
- ``leaves(gen, train)``: the encoding's learnable leaves (float32, on the
  CPU; an empty list where it has none), drawn from the job's CPU generator
  right after the MLP's weights, in the order the port draws them. The
  reference trains them with the MLP's leaves, in Adam's group at the
  schedule's lr; they sit after the MLP's leaves and before the view shifts;
- ``encode(x, leaves, step, train)``: the MLP's input at scaled (P, 3)
  positions, with the leaves' current values at step ``step`` (0 for the
  first step).
"""

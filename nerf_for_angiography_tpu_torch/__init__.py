"""nerf_for_angiography_tpu_torch: the PyTorch/CUDA port of
``nerf_for_angiography_tpu`` for NVIDIA Hopper (H100).

Layer map (mirrors the JAX package's paths):
  geometry/      C-arm pose math + pinhole rays
  models/        CPPN coordinate MLP (nn.Module)
  ops/           occupancy grid + dense march, ray sampling, interpolation
  ops/kernels/   hand-written Hopper kernels (sources in csrc/) with their
                 plain PyTorch versions
  data/          phantoms, DRR datagen, Frangi weights
  training/      config, train step, eval step, training loop
  convert.py     flax CPPN params -> the port's state_dict

Entry points (``train``, ``generate_dataset``, ``create_train_state``) run
on the card unless called with ``device="cpu"``.
"""

__version__ = "0.1.0"

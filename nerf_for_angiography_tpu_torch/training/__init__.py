from .checkpoint import (
    CheckpointManager,
    load_grid_vtk,
    load_model,
    save_grid_vtk,
    save_model,
)
from .config import REFERENCE_STRICT_OVERRIDES, TrainConfig, categories_for, lca_protocol
from .logging import ExperimentLogger
from .loop import TrainResult, build_page_data, train
from .train import (
    TestView,
    TrainState,
    check_ported,
    copy_state,
    create_train_state,
    density_raw,
    drop_test_view,
    make_eval_step,
    make_optimizer,
    make_test_view,
    make_train_chunk,
    make_train_step,
    render_rays,
)

__all__ = [
    "CheckpointManager",
    "ExperimentLogger",
    "REFERENCE_STRICT_OVERRIDES",
    "TestView",
    "TrainConfig",
    "TrainResult",
    "TrainState",
    "build_page_data",
    "categories_for",
    "check_ported",
    "copy_state",
    "create_train_state",
    "density_raw",
    "drop_test_view",
    "load_grid_vtk",
    "lca_protocol",
    "load_model",
    "make_eval_step",
    "make_optimizer",
    "make_test_view",
    "make_train_chunk",
    "make_train_step",
    "render_rays",
    "save_grid_vtk",
    "save_model",
    "train",
]

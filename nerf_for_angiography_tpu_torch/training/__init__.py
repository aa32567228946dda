from .config import REFERENCE_STRICT_OVERRIDES, TrainConfig, categories_for
from .loop import TrainResult, build_page_data, train
from .train import (
    TestView,
    TrainState,
    check_ported,
    create_train_state,
    density_raw,
    drop_test_view,
    make_eval_step,
    make_optimizer,
    make_test_view,
    make_train_step,
    render_rays,
)

__all__ = [
    "REFERENCE_STRICT_OVERRIDES",
    "TestView",
    "TrainConfig",
    "TrainResult",
    "TrainState",
    "build_page_data",
    "categories_for",
    "check_ported",
    "create_train_state",
    "density_raw",
    "drop_test_view",
    "make_eval_step",
    "make_optimizer",
    "make_test_view",
    "make_train_step",
    "render_rays",
    "train",
]

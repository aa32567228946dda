"""``pos_enc='none'``: the MLP reads the scaled position itself."""


def in_dim(train: dict) -> int:
    return 3


def encode(x, train: dict):
    return x

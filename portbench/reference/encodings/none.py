"""``pos_enc='none'``: the MLP reads the scaled position itself."""


def in_dim(train: dict) -> int:
    return 3


def leaves(gen, train: dict) -> list:
    return []


def encode(x, leaves, step: int, train: dict):
    return x

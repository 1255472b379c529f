from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adafactor, adamw, get_optimizer, sgd)

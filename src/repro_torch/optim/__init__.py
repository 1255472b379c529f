from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adafactor, adamw, get_optimizer, sgd)
from repro_torch.optim.zo import (  # noqa: F401
    distributed_zo_signsgd_step, zo_signsgd_trainer_step)

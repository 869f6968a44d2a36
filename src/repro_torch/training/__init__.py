"""Training of the ssm, dense, moe and hybrid LM families (the port of ``src/repro/training``): AdamW,
the train step and the fault-tolerant trainer."""
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.steps import TrainOptions, init_train_state, make_train_step
from repro_torch.training.trainer import StragglerMonitor, Trainer, TrainerConfig

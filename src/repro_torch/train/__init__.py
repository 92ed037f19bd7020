from repro_torch.train.loop import LoopConfig, LoopReport, TrainLoop
from repro_torch.train.step import init_train_state, make_train_step

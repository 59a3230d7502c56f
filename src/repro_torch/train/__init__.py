from repro_torch.train.train_step import make_eval_step, make_loss, make_train_step

__all__ = ["make_eval_step", "make_loss", "make_train_step"]

from .train_step import adam, adamw, make_train_step, t3_loss

__all__ = ["adam", "adamw", "make_train_step", "t3_loss"]

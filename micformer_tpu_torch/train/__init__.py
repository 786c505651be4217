"""The training harness: config, schedules, checkpoints, meters, the trainer.
`Trainer` and `TrainConfig` load on first use (the trainer imports the model
zoo's layers)."""

__all__ = ["TrainConfig", "Trainer"]


def __getattr__(name):
    if name in __all__:
        from micformer_tpu_torch.train import trainer

        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

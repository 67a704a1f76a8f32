from .engine import DeepSpeedTPUEngine, TrainState

__all__ = ["DeepSpeedTPUEngine", "TrainState"]

from .experiment import Experiment
from .plot_factory import PlotFactory
from . import metrics

__all__ = ["Experiment", "PlotFactory", "metrics"]

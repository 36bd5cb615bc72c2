"""The paper's synthetic problems."""

from .synthetic import (accuracy, linear_classification_problem,
                        mean_estimation_problem, two_cluster_mean_problem)

__all__ = ["accuracy", "linear_classification_problem",
           "mean_estimation_problem", "two_cluster_mean_problem"]

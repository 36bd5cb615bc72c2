"""The paper's synthetic problems."""

from .synthetic import (accuracy, federated_moons_problem,
                        linear_classification_problem,
                        mean_estimation_problem, model_accuracy,
                        two_cluster_mean_problem)

__all__ = ["accuracy", "federated_moons_problem",
           "linear_classification_problem", "mean_estimation_problem",
           "model_accuracy", "two_cluster_mean_problem"]

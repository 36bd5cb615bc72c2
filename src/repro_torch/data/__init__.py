"""The paper's synthetic model-propagation problems."""

from .synthetic import mean_estimation_problem, two_cluster_mean_problem

__all__ = ["mean_estimation_problem", "two_cluster_mean_problem"]

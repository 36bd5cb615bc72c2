"""The paper's synthetic problems and the personalized LM streams."""

from .synthetic import (PersonalizedLMConfig, accuracy,
                        federated_moons_problem,
                        linear_classification_problem, make_lm_batches,
                        mean_estimation_problem, model_accuracy,
                        personalized_token_stream, two_cluster_mean_problem)

__all__ = ["PersonalizedLMConfig", "accuracy", "federated_moons_problem",
           "linear_classification_problem", "make_lm_batches",
           "mean_estimation_problem", "model_accuracy",
           "personalized_token_stream", "two_cluster_mean_problem"]

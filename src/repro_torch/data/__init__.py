"""The paper's synthetic problems, the personalized LM streams and the
MusicGen delay pattern."""

from .synthetic import (PersonalizedLMConfig, accuracy, delay_pattern,
                        federated_moons_problem,
                        linear_classification_problem, make_lm_batches,
                        mean_estimation_problem, model_accuracy,
                        personalized_token_stream, two_cluster_mean_problem,
                        undelay_pattern)

__all__ = ["PersonalizedLMConfig", "accuracy", "delay_pattern",
           "federated_moons_problem", "linear_classification_problem",
           "make_lm_batches", "mean_estimation_problem", "model_accuracy",
           "personalized_token_stream", "two_cluster_mean_problem",
           "undelay_pattern"]

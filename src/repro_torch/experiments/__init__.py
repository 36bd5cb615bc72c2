"""Paper-style experiment drivers: multi-trial sweeps over seeds and
hyperparameters (counterpart of ``repro.experiments``)."""

from .sweep import (ADMMSweepResult, ADMMTrials, JointSweepResult,
                    JointTrials, MPSweepResult, MPTrials,
                    ScenarioSweepResult, admm_mean_estimation_trials,
                    closed_form_comparison, inexact_primal_axis,
                    joint_mean_estimation_trials, mean_estimation_trials,
                    run_admm_sweep, run_joint_sweep, run_mp_sweep,
                    run_scenario_sweep)

__all__ = [n for n in dir() if not n.startswith("_")]

"""ClearML hyper-parameter optimisation over a template training task
(yolov3_tpu/utils/loggers/clearml_hpo.py, reference
utils/loggers/clearml/hpo.py): the search space is the one `--evolve`
mutates (train/evolve.py META). clearml is imported inside each function."""

from __future__ import annotations

from yolov3_tpu_torch.utils.general import LOGGER


def build_search_space():
    """One UniformParameterRange "Hyperparameters/<key>" per evolve bound."""
    from clearml.automation import UniformParameterRange

    from yolov3_tpu_torch.train.evolve import META

    return [UniformParameterRange(f"Hyperparameters/{k}", min_value=float(lo), max_value=float(hi))
            for k, (_, lo, hi) in META.items()]


def run_clearml_hpo(base_task_id, project_name="Hyper-Parameter Optimization", task_name="yolov3_tpu",
                    objective_metric=("metrics", "mAP_0.5"), max_concurrent=1, total_max_jobs=20, save_top_k=5,
                    time_limit_minutes=120.0, run_locally=True):
    """Optimise the template task's hyper-parameters (Optuna when
    clearml's optuna search is installed, random search otherwise), maximising
    `objective_metric`; returns the optimizer once it has finished."""
    from clearml import Task
    from clearml.automation import HyperParameterOptimizer, RandomSearch

    try:
        from clearml.automation.optuna import OptimizerOptuna as optimizer_class
    except ImportError:
        optimizer_class = RandomSearch
        LOGGER.warning("clearml-optuna not installed — falling back to RandomSearch")

    Task.init(project_name=project_name, task_name=task_name, task_type=Task.TaskTypes.optimizer,
              reuse_last_task_id=False)
    optimizer = HyperParameterOptimizer(
        base_task_id=base_task_id, hyper_parameters=build_search_space(),
        objective_metric_title=objective_metric[0], objective_metric_series=objective_metric[1],
        objective_metric_sign="max", max_number_of_concurrent_tasks=max_concurrent,
        optimizer_class=optimizer_class, save_top_k_tasks_only=save_top_k, compute_time_limit=None,
        total_max_jobs=total_max_jobs, min_iteration_per_job=None, max_iteration_per_job=None)
    optimizer.set_report_period(10 / 60)
    optimizer.set_time_limit(in_minutes=time_limit_minutes)
    if run_locally:
        optimizer.start_locally()
    else:
        optimizer.start()
    optimizer.wait()
    optimizer.stop()
    return optimizer

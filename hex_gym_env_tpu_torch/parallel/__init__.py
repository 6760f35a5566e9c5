"""Multi-process runtime.  Only ``bootstrap.is_main_process`` is ported so
far; the data-parallel learner and the sharded evaluator are still to come
(ROADMAP.md, queue 1, "parallel/")."""

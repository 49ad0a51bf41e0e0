"""The quality-soak recipe (``python -m a3t_tpu_torch.recipes.soak.run``),
its steps-vs-MCD evaluator (``.curve_eval``), its report assemblers
(``.assemble_mcd_report``, ``.assemble_mcd_r05``) and its launchers
(``launch_spemb.sh``, ``spemb_watch.sh``, ``post_train.sh``)."""

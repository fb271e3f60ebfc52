"""Copied from ``lightgbm_tpu/_params_meta.py`` for the PyTorch port (which imports nothing of
the JAX package); only imports and device hooks differ.

Parameter metadata extracted from the reference config (include/LightGBM/config.h doc comments).

AUTO-GENERATED by tools/gen_params.py -- do not edit by hand.
"""

PARAMS = [
    {'name': 'config', 'type': 'str', 'default': '', 'aliases': ['config_file'], 'checks': [], 'options': [], 'section': 'Core'},
    {'name': 'objective', 'type': 'str', 'default': 'regression', 'aliases': ['objective_type', 'app', 'application'], 'checks': [], 'options': ['regression', 'regression_l1', 'huber', 'fair', 'poisson', 'quantile', 'mape', 'gamma', 'tweedie', 'binary', 'multiclass', 'multiclassova', 'cross_entropy', 'cross_entropy_lambda', 'lambdarank', 'rank_xendcg'], 'section': 'Core'},
    {'name': 'boosting', 'type': 'str', 'default': 'gbdt', 'aliases': ['boosting_type', 'boost'], 'checks': [], 'options': ['gbdt', 'rf', 'dart', 'goss'], 'section': 'Core'},
    {'name': 'data', 'type': 'str', 'default': '', 'aliases': ['train', 'train_data', 'train_data_file', 'data_filename'], 'checks': [], 'options': [], 'section': 'Core'},
    {'name': 'valid', 'type': 'list_str', 'default': [], 'aliases': ['test', 'valid_data', 'valid_data_file', 'test_data', 'test_data_file', 'valid_filenames'], 'checks': [], 'options': [], 'section': 'Core'},
    {'name': 'num_iterations', 'type': 'int', 'default': 100, 'aliases': ['num_iteration', 'n_iter', 'num_tree', 'num_trees', 'num_round', 'num_rounds', 'num_boost_round', 'n_estimators'], 'checks': ['>=0'], 'options': [], 'section': 'Core'},
    {'name': 'learning_rate', 'type': 'float', 'default': 0.1, 'aliases': ['shrinkage_rate', 'eta'], 'checks': ['>0.0'], 'options': [], 'section': 'Core'},
    {'name': 'num_leaves', 'type': 'int', 'default': 31, 'aliases': ['num_leaf', 'max_leaves', 'max_leaf'], 'checks': ['>1', '<=131072'], 'options': [], 'section': 'Core'},
    {'name': 'tree_learner', 'type': 'str', 'default': 'serial', 'aliases': ['tree', 'tree_type', 'tree_learner_type'], 'checks': [], 'options': ['serial', 'feature', 'data', 'voting'], 'section': 'Core'},
    {'name': 'num_threads', 'type': 'int', 'default': 0, 'aliases': ['num_thread', 'nthread', 'nthreads', 'n_jobs'], 'checks': [], 'options': [], 'section': 'Core'},
    {'name': 'device_type', 'type': 'str', 'default': 'cpu', 'aliases': ['device'], 'checks': [], 'options': ['cpu', 'gpu'], 'section': 'Core'},
    {'name': 'seed', 'type': 'int', 'default': 0, 'aliases': ['random_seed', 'random_state'], 'checks': [], 'options': [], 'section': 'Core'},
    {'name': 'force_col_wise', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'force_row_wise', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'max_depth', 'type': 'int', 'default': -1, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'min_data_in_leaf', 'type': 'int', 'default': 20, 'aliases': ['min_data_per_leaf', 'min_data', 'min_child_samples'], 'checks': ['>=0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'min_sum_hessian_in_leaf', 'type': 'float', 'default': 0.001, 'aliases': ['min_sum_hessian_per_leaf', 'min_sum_hessian', 'min_hessian', 'min_child_weight'], 'checks': ['>=0.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'bagging_fraction', 'type': 'float', 'default': 1.0, 'aliases': ['sub_row', 'subsample', 'bagging'], 'checks': ['>0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'pos_bagging_fraction', 'type': 'float', 'default': 1.0, 'aliases': ['pos_sub_row', 'pos_subsample', 'pos_bagging'], 'checks': ['>0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'neg_bagging_fraction', 'type': 'float', 'default': 1.0, 'aliases': ['neg_sub_row', 'neg_subsample', 'neg_bagging'], 'checks': ['>0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'bagging_freq', 'type': 'int', 'default': 0, 'aliases': ['subsample_freq'], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'bagging_seed', 'type': 'int', 'default': 3, 'aliases': ['bagging_fraction_seed'], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'feature_fraction', 'type': 'float', 'default': 1.0, 'aliases': ['sub_feature', 'colsample_bytree'], 'checks': ['>0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'feature_fraction_bynode', 'type': 'float', 'default': 1.0, 'aliases': ['sub_feature_bynode', 'colsample_bynode'], 'checks': ['>0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'feature_fraction_seed', 'type': 'int', 'default': 2, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'extra_trees', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'extra_seed', 'type': 'int', 'default': 6, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'early_stopping_round', 'type': 'int', 'default': 0, 'aliases': ['early_stopping_rounds', 'early_stopping', 'n_iter_no_change'], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'first_metric_only', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'max_delta_step', 'type': 'float', 'default': 0.0, 'aliases': ['max_tree_output', 'max_leaf_output'], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'lambda_l1', 'type': 'float', 'default': 0.0, 'aliases': ['reg_alpha'], 'checks': ['>=0.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'lambda_l2', 'type': 'float', 'default': 0.0, 'aliases': ['reg_lambda', 'lambda'], 'checks': ['>=0.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'min_gain_to_split', 'type': 'float', 'default': 0.0, 'aliases': ['min_split_gain'], 'checks': ['>=0.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'drop_rate', 'type': 'float', 'default': 0.1, 'aliases': ['rate_drop'], 'checks': ['>=0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'max_drop', 'type': 'int', 'default': 50, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'skip_drop', 'type': 'float', 'default': 0.5, 'aliases': [], 'checks': ['>=0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'xgboost_dart_mode', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'uniform_drop', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'drop_seed', 'type': 'int', 'default': 4, 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'top_rate', 'type': 'float', 'default': 0.2, 'aliases': [], 'checks': ['>=0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'other_rate', 'type': 'float', 'default': 0.1, 'aliases': [], 'checks': ['>=0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'min_data_per_group', 'type': 'int', 'default': 100, 'aliases': [], 'checks': ['>0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'max_cat_threshold', 'type': 'int', 'default': 32, 'aliases': [], 'checks': ['>0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'cat_l2', 'type': 'float', 'default': 10.0, 'aliases': [], 'checks': ['>=0.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'cat_smooth', 'type': 'float', 'default': 10.0, 'aliases': [], 'checks': ['>=0.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'max_cat_to_onehot', 'type': 'int', 'default': 4, 'aliases': [], 'checks': ['>0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'top_k', 'type': 'int', 'default': 20, 'aliases': ['topk'], 'checks': ['>0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'monotone_constraints', 'type': 'list_int', 'default': [], 'aliases': ['mc', 'monotone_constraint'], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'feature_contri', 'type': 'list_float', 'default': [], 'aliases': ['feature_contrib', 'fc', 'fp', 'feature_penalty'], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'forcedsplits_filename', 'type': 'str', 'default': '', 'aliases': ['fs', 'forced_splits_filename', 'forced_splits_file', 'forced_splits'], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'forcedbins_filename', 'type': 'str', 'default': '', 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'refit_decay_rate', 'type': 'float', 'default': 0.9, 'aliases': [], 'checks': ['>=0.0', '<=1.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'cegb_tradeoff', 'type': 'float', 'default': 1.0, 'aliases': [], 'checks': ['>=0.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'cegb_penalty_split', 'type': 'float', 'default': 0.0, 'aliases': [], 'checks': ['>=0.0'], 'options': [], 'section': 'Learning Control'},
    {'name': 'cegb_penalty_feature_lazy', 'type': 'list_float', 'default': [], 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'cegb_penalty_feature_coupled', 'type': 'list_float', 'default': [], 'aliases': [], 'checks': [], 'options': [], 'section': 'Learning Control'},
    {'name': 'verbosity', 'type': 'int', 'default': 1, 'aliases': ['verbose'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'max_bin', 'type': 'int', 'default': 255, 'aliases': [], 'checks': ['>1'], 'options': [], 'section': 'IO'},
    {'name': 'is_enable_sparse', 'type': 'bool', 'default': True, 'aliases': ['is_sparse', 'enable_sparse', 'sparse'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'max_bin_by_feature', 'type': 'list_int', 'default': [], 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'min_data_in_bin', 'type': 'int', 'default': 3, 'aliases': [], 'checks': ['>0'], 'options': [], 'section': 'IO'},
    {'name': 'bin_construct_sample_cnt', 'type': 'int', 'default': 200000, 'aliases': ['subsample_for_bin'], 'checks': ['>0'], 'options': [], 'section': 'IO'},
    {'name': 'histogram_pool_size', 'type': 'float', 'default': -1.0, 'aliases': ['hist_pool_size'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'data_random_seed', 'type': 'int', 'default': 1, 'aliases': ['data_seed'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'output_model', 'type': 'str', 'default': 'LightGBM_model.txt', 'aliases': ['model_output', 'model_out'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'snapshot_freq', 'type': 'int', 'default': -1, 'aliases': ['save_period'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'input_model', 'type': 'str', 'default': '', 'aliases': ['model_input', 'model_in'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'output_result', 'type': 'str', 'default': 'LightGBM_predict_result.txt', 'aliases': ['predict_result', 'prediction_result', 'predict_name', 'prediction_name', 'pred_name', 'name_pred'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'initscore_filename', 'type': 'str', 'default': '', 'aliases': ['init_score_filename', 'init_score_file', 'init_score', 'input_init_score'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'valid_data_initscores', 'type': 'list_str', 'default': [], 'aliases': ['valid_data_init_scores', 'valid_init_score_file', 'valid_init_score'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'pre_partition', 'type': 'bool', 'default': False, 'aliases': ['is_pre_partition'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'enable_bundle', 'type': 'bool', 'default': True, 'aliases': ['is_enable_bundle', 'bundle'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'use_missing', 'type': 'bool', 'default': True, 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'zero_as_missing', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'two_round', 'type': 'bool', 'default': False, 'aliases': ['two_round_loading', 'use_two_round_loading'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'save_binary', 'type': 'bool', 'default': False, 'aliases': ['is_save_binary', 'is_save_binary_file'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'header', 'type': 'bool', 'default': False, 'aliases': ['has_header'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'label_column', 'type': 'str', 'default': '', 'aliases': ['label'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'weight_column', 'type': 'str', 'default': '', 'aliases': ['weight'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'group_column', 'type': 'str', 'default': '', 'aliases': ['group', 'group_id', 'query_column', 'query', 'query_id'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'ignore_column', 'type': 'str', 'default': '', 'aliases': ['ignore_feature', 'blacklist'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'categorical_feature', 'type': 'str', 'default': '', 'aliases': ['cat_feature', 'categorical_column', 'cat_column'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'predict_raw_score', 'type': 'bool', 'default': False, 'aliases': ['is_predict_raw_score', 'predict_rawscore', 'raw_score'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'predict_leaf_index', 'type': 'bool', 'default': False, 'aliases': ['is_predict_leaf_index', 'leaf_index'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'predict_contrib', 'type': 'bool', 'default': False, 'aliases': ['is_predict_contrib', 'contrib'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'num_iteration_predict', 'type': 'int', 'default': -1, 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'pred_early_stop', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'pred_early_stop_freq', 'type': 'int', 'default': 10, 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'pred_early_stop_margin', 'type': 'float', 'default': 10.0, 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'predict_disable_shape_check', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'convert_model_language', 'type': 'str', 'default': '', 'aliases': [], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'convert_model', 'type': 'str', 'default': 'gbdt_prediction.cpp', 'aliases': ['convert_model_file'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'num_class', 'type': 'int', 'default': 1, 'aliases': ['num_classes'], 'checks': ['>0'], 'options': [], 'section': 'Objective'},
    {'name': 'is_unbalance', 'type': 'bool', 'default': False, 'aliases': ['unbalance', 'unbalanced_sets'], 'checks': [], 'options': [], 'section': 'Objective'},
    {'name': 'scale_pos_weight', 'type': 'float', 'default': 1.0, 'aliases': [], 'checks': ['>0.0'], 'options': [], 'section': 'Objective'},
    {'name': 'sigmoid', 'type': 'float', 'default': 1.0, 'aliases': [], 'checks': ['>0.0'], 'options': [], 'section': 'Objective'},
    {'name': 'boost_from_average', 'type': 'bool', 'default': True, 'aliases': [], 'checks': [], 'options': [], 'section': 'Objective'},
    {'name': 'reg_sqrt', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'Objective'},
    {'name': 'alpha', 'type': 'float', 'default': 0.9, 'aliases': [], 'checks': ['>0.0'], 'options': [], 'section': 'Objective'},
    {'name': 'fair_c', 'type': 'float', 'default': 1.0, 'aliases': [], 'checks': ['>0.0'], 'options': [], 'section': 'Objective'},
    {'name': 'poisson_max_delta_step', 'type': 'float', 'default': 0.7, 'aliases': [], 'checks': ['>0.0'], 'options': [], 'section': 'Objective'},
    {'name': 'tweedie_variance_power', 'type': 'float', 'default': 1.5, 'aliases': [], 'checks': ['>=1.0', '<2.0'], 'options': [], 'section': 'Objective'},
    {'name': 'max_position', 'type': 'int', 'default': 20, 'aliases': [], 'checks': ['>0'], 'options': [], 'section': 'Objective'},
    {'name': 'lambdamart_norm', 'type': 'bool', 'default': True, 'aliases': [], 'checks': [], 'options': [], 'section': 'Objective'},
    {'name': 'label_gain', 'type': 'list_float', 'default': [], 'aliases': [], 'checks': [], 'options': [], 'section': 'Objective'},
    {'name': 'objective_seed', 'type': 'int', 'default': 5, 'aliases': [], 'checks': [], 'options': [], 'section': 'Objective'},
    {'name': 'metric', 'type': 'list_str', 'default': [], 'aliases': ['metrics', 'metric_types'], 'checks': [], 'options': [], 'section': 'Metric'},
    {'name': 'metric_freq', 'type': 'int', 'default': 1, 'aliases': ['output_freq'], 'checks': ['>0'], 'options': [], 'section': 'Metric'},
    {'name': 'is_provide_training_metric', 'type': 'bool', 'default': False, 'aliases': ['training_metric', 'is_training_metric', 'train_metric'], 'checks': [], 'options': [], 'section': 'Metric'},
    {'name': 'eval_at', 'type': 'list_int', 'default': [], 'aliases': ['ndcg_eval_at', 'ndcg_at', 'map_eval_at', 'map_at'], 'checks': [], 'options': [], 'section': 'Metric'},
    {'name': 'multi_error_top_k', 'type': 'int', 'default': 1, 'aliases': [], 'checks': ['>0'], 'options': [], 'section': 'Metric'},
    {'name': 'auc_mu_weights', 'type': 'list_float', 'default': [], 'aliases': [], 'checks': [], 'options': [], 'section': 'Metric'},
    {'name': 'num_machines', 'type': 'int', 'default': 1, 'aliases': ['num_machine'], 'checks': ['>0'], 'options': [], 'section': 'Network'},
    {'name': 'local_listen_port', 'type': 'int', 'default': 12400, 'aliases': ['local_port', 'port'], 'checks': ['>0'], 'options': [], 'section': 'Network'},
    {'name': 'time_out', 'type': 'int', 'default': 120, 'aliases': [], 'checks': ['>0'], 'options': [], 'section': 'Network'},
    {'name': 'machine_list_filename', 'type': 'str', 'default': '', 'aliases': ['machine_list_file', 'machine_list', 'mlist'], 'checks': [], 'options': [], 'section': 'Network'},
    {'name': 'machines', 'type': 'str', 'default': '', 'aliases': ['workers', 'nodes'], 'checks': [], 'options': [], 'section': 'Network'},
    {'name': 'gpu_platform_id', 'type': 'int', 'default': -1, 'aliases': [], 'checks': [], 'options': [], 'section': 'GPU'},
    {'name': 'gpu_device_id', 'type': 'int', 'default': -1, 'aliases': [], 'checks': [], 'options': [], 'section': 'GPU'},
    {'name': 'gpu_use_dp', 'type': 'bool', 'default': False, 'aliases': [], 'checks': [], 'options': [], 'section': 'GPU'},
]

# TPU-runtime extensions (not in the reference config.h; kept separate so a
# regeneration of the extracted block above preserves them — tools/gen_params.py
# appends this tail verbatim):
# - snapshot_keep: bounded retention for snapshot_freq checkpoint/model files
#   (newest N kept; <= 0 keeps everything)
# - nan_policy: non-finite gradient/hessian/score guard policy
# - telemetry_out: JSONL event-sink path for the obs subsystem; empty (the
#   default) keeps telemetry fully off — the hot loops make zero telemetry
#   calls.  A run with it set also writes <path>.summary.json at the end.
# - telemetry_freq: per-iteration telemetry event cadence (record every Nth
#   iteration); only consulted when telemetry_out is set
# - preemption_checkpoint: install the SIGTERM/SIGINT handler (resilience.py)
#   that makes task=train exit via an emergency checkpoint + EXIT_PREEMPTED
# - watchdog_timeout_s: abort a dispatch/collective that makes no progress
#   for this many seconds, dumping a diagnostic artifact first (0 = off)
# - io_retry_attempts / io_retry_backoff_s: bounded jittered retry policy
#   for transient checkpoint/model/telemetry file-I/O faults
# - tree_grow_mode: leaf (reference leaf-wise growth, one fused split-kernel
#   launch per grown leaf) or level (max_depth-driven BFS: all frontier
#   leaves of a level split by at most one multi-window launch per kernel
#   size class — <= depth * classes launches per tree; needs the fused TPU
#   path and falls back to leaf with a warning otherwise)
# - trees_per_chunk: boosting iterations grouped per step of a fused chunk
#   (GBDT.train_chunk); the JAX package unrolls a group into one scan step
#   to share its dispatch cost, the port runs the same calls in the same
#   order, so results are bit-exact vs 1
# - max_batch_wait_us: serving-tier coalescing window — how long the
#   continuous-batching scheduler holds an open batch for compatible
#   requests before padding to the shape-bucket ladder and dispatching
# - serve_residency_budget_mb: multi-model residency budget (stacked device
#   ensembles, LRU-evicted past it; <= 0 = unlimited)
# - serve_single_row_fast: route batch-size-1 requests through the compiled
#   in-process if/else chain (model_codegen.compile_single_row) instead of
#   a padded device dispatch; bit-exact vs predict_blocked
# - predict_precision: serving/predict tier — exact (the default: bit-exact
#   f32 scores) or bf16 (lossy: bf16 leaf values + accumulate; leaf routing
#   stays bit-exact).  The bf16 tier's measured score error is budget-gated
#   (PERF_BUDGETS.json bf16_max_score_delta via tools/perf_gate.py); contrib
#   requests have no lossy tier
# - metrics_port: serve the live observability plane (obs/exporter.py:
#   /metrics Prometheus text, /healthz, /summary.json) from an HTTP
#   listener on this port for the duration of the run; 0 (the default)
#   starts no listener thread at all
# - metrics_addr: bind address for the metrics_port listener (default
#   loopback; set 0.0.0.0 to scrape from another host)
# - quality_monitor: model-quality plane (obs/quality.py) — per-feature
#   drift PSI/JS, score-distribution PSI and generation/freshness gauges
#   over served/scored traffic; only active while a telemetry run is
#   (telemetry_out / metrics_port / obs.configure), costs nothing
#   otherwise
# - quality_top_k: how many per-feature drift series each model exposes
#   on /metrics and in the summary (ranked by importance x PSI; bounds
#   exposition size on wide-F models)
# - alert_rules: JSON file of live SLO alert rules (obs/alerts.py; the
#   PERF_BUDGETS.json "alerts" list shape) evaluated periodically over
#   the run's metrics with fast/slow burn-rate windows, served at
#   /alerts and emitted as kind="alert" events; empty (the default)
#   installs no engine
# - alert_interval_s: evaluation period of the alert engine
# - flight_recorder: arm ONE automatic jax.profiler capture per run
#   (obs/profiling.py), fired by the first watchdog stall or the first
#   live SLO alert; artifacts land under <telemetry_out>.profiles/
# - online_* (lightgbm_tpu/online, task=online / lgb.serve_and_train):
#   online_rounds = boosting iterations per retrain cycle (extend mode);
#   online_update = extend (warm-start continuation: more trees per
#   generation) or refit (re-fit leaf values on the window — structure
#   unchanged, republish is a pure jit-cache hit);
#   online_min_rows / online_interval_s = cadence triggers (fire every N
#   fresh rows / every T seconds while fresh rows exist; 0 = off);
#   online_drift_trigger = fire when the quality plane's per-model drift
#   level reads "alert" (the round-15 snapshot()["models"][m]["level"]
#   hook); online_max_rows_behind / online_max_seconds_behind = freshness
#   SLO caps (0 = off); online_buffer_rows = bounded ingest buffer
#   (drop-oldest past it, counted); online_window_rows = max rows per
#   training window (0 = the whole buffer); online_poll_s = trigger poll
#   period of the trainer thread; online_feed = CLI task=online labeled
#   feed file replayed as ingest + requests
# - plan_cache (lightgbm_tpu/plan, round 18): path to the persisted
#   tuned-plan cache the kernel planner consults (written by
#   tools/bench_autotune.py).  Empty = probe the default location next to
#   the XLA compilation cache; missing/corrupt/stale caches degrade to
#   analytic plans with one warning + the plan_cache_fallbacks counter
# - hist_precision (core/quant.py round 22): exact keeps the byte-identical
#   f32 hi/lo histogram default; quantized stochastically rounds grad/hess
#   to low-bit integers per boosting iteration (stateless hash keyed like
#   the bagging mask) so histogram kernels run a 2-row integer operand and
#   the parallel learners' hist collective rides a half-width payload —
#   lossy, budgeted by PERF_BUDGETS.json quant_* lines
# - data_chunk_rows (io/loader.py round 21): streaming two-pass ingestion —
#   text data is read, sampled and binned in chunks of this many rows, so
#   peak host RSS is bounded by the chunk (plus the bin sample and the
#   packed store) instead of the raw f64 matrix; bit-identical to the
#   in-memory loader.  0 (the default) keeps the one-shot parse;
#   incompatible with pre_partition=true (the file would be double-sharded)
# - ingest_pipeline_depth: prefetch depth of the streaming loader's
#   producer thread (parse of chunk k+depth overlaps binning of chunk k;
#   1 disables overlap, the PipelineReader role)
PARAMS += [
    {'name': 'snapshot_keep', 'type': 'int', 'default': 3, 'aliases': ['checkpoint_keep', 'save_keep'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'nan_policy', 'type': 'str', 'default': 'raise', 'aliases': ['non_finite_policy'], 'checks': [], 'options': ['raise', 'skip_iter', 'clip'], 'section': 'Learning Control'},
    {'name': 'telemetry_out', 'type': 'str', 'default': '', 'aliases': ['telemetry_output', 'telemetry_file'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'telemetry_freq', 'type': 'int', 'default': 1, 'aliases': ['telemetry_frequency'], 'checks': ['>0'], 'options': [], 'section': 'IO'},
    {'name': 'preemption_checkpoint', 'type': 'bool', 'default': False, 'aliases': ['preempt_checkpoint'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'watchdog_timeout_s', 'type': 'float', 'default': 0.0, 'aliases': ['watchdog_timeout'], 'checks': ['>=0.0'], 'options': [], 'section': 'IO'},
    {'name': 'io_retry_attempts', 'type': 'int', 'default': 3, 'aliases': [], 'checks': ['>=1'], 'options': [], 'section': 'IO'},
    {'name': 'io_retry_backoff_s', 'type': 'float', 'default': 0.05, 'aliases': [], 'checks': ['>=0.0'], 'options': [], 'section': 'IO'},
    {'name': 'tree_grow_mode', 'type': 'str', 'default': 'leaf', 'aliases': ['grow_mode', 'grow_policy'], 'checks': [], 'options': ['leaf', 'level'], 'section': 'Learning Control'},
    {'name': 'trees_per_chunk', 'type': 'int', 'default': 1, 'aliases': [], 'checks': ['>=1'], 'options': [], 'section': 'Learning Control'},
    {'name': 'hist_precision', 'type': 'str', 'default': 'exact', 'aliases': ['quantized_grad'], 'checks': [], 'options': ['exact', 'quantized'], 'section': 'Learning Control'},
    {'name': 'max_batch_wait_us', 'type': 'int', 'default': 200, 'aliases': ['serve_batch_wait_us'], 'checks': ['>=0'], 'options': [], 'section': 'Serving'},
    {'name': 'serve_residency_budget_mb', 'type': 'float', 'default': 1024.0, 'aliases': ['residency_budget_mb'], 'checks': [], 'options': [], 'section': 'Serving'},
    {'name': 'serve_single_row_fast', 'type': 'bool', 'default': False, 'aliases': ['single_row_fast'], 'checks': [], 'options': [], 'section': 'Serving'},
    {'name': 'predict_precision', 'type': 'str', 'default': 'exact', 'aliases': ['serve_precision'], 'checks': [], 'options': ['exact', 'bf16'], 'section': 'Serving'},
    {'name': 'metrics_port', 'type': 'int', 'default': 0, 'aliases': ['telemetry_port'], 'checks': ['>=0', '<=65535'], 'options': [], 'section': 'IO'},
    {'name': 'metrics_addr', 'type': 'str', 'default': '127.0.0.1', 'aliases': ['telemetry_addr'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'quality_monitor', 'type': 'bool', 'default': True, 'aliases': ['drift_monitor'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'quality_top_k', 'type': 'int', 'default': 20, 'aliases': ['drift_top_k'], 'checks': ['>0'], 'options': [], 'section': 'IO'},
    {'name': 'alert_rules', 'type': 'str', 'default': '', 'aliases': ['alert_rules_file', 'slo_rules'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'alert_interval_s', 'type': 'float', 'default': 1.0, 'aliases': ['alert_eval_s'], 'checks': ['>0.0'], 'options': [], 'section': 'IO'},
    {'name': 'flight_recorder', 'type': 'bool', 'default': False, 'aliases': ['profile_on_incident'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'online_rounds', 'type': 'int', 'default': 10, 'aliases': ['online_trees_per_cycle'], 'checks': ['>=1'], 'options': [], 'section': 'Online'},
    {'name': 'online_update', 'type': 'str', 'default': 'extend', 'aliases': ['online_mode'], 'checks': [], 'options': ['extend', 'refit'], 'section': 'Online'},
    {'name': 'online_min_rows', 'type': 'int', 'default': 4096, 'aliases': ['online_cadence_rows'], 'checks': ['>=0'], 'options': [], 'section': 'Online'},
    {'name': 'online_interval_s', 'type': 'float', 'default': 0.0, 'aliases': ['online_cadence_s'], 'checks': ['>=0.0'], 'options': [], 'section': 'Online'},
    {'name': 'online_drift_trigger', 'type': 'bool', 'default': True, 'aliases': ['online_drift_refit'], 'checks': [], 'options': [], 'section': 'Online'},
    {'name': 'online_max_rows_behind', 'type': 'int', 'default': 0, 'aliases': [], 'checks': ['>=0'], 'options': [], 'section': 'Online'},
    {'name': 'online_max_seconds_behind', 'type': 'float', 'default': 0.0, 'aliases': [], 'checks': ['>=0.0'], 'options': [], 'section': 'Online'},
    {'name': 'online_buffer_rows', 'type': 'int', 'default': 1048576, 'aliases': [], 'checks': ['>=1'], 'options': [], 'section': 'Online'},
    {'name': 'online_window_rows', 'type': 'int', 'default': 0, 'aliases': [], 'checks': ['>=0'], 'options': [], 'section': 'Online'},
    {'name': 'online_poll_s', 'type': 'float', 'default': 0.25, 'aliases': [], 'checks': ['>0.0'], 'options': [], 'section': 'Online'},
    {'name': 'online_feed', 'type': 'str', 'default': '', 'aliases': ['online_feed_file'], 'checks': [], 'options': [], 'section': 'Online'},
    {'name': 'plan_cache', 'type': 'str', 'default': '', 'aliases': ['kernel_plan_cache', 'plan_cache_file'], 'checks': [], 'options': [], 'section': 'IO'},
    {'name': 'data_chunk_rows', 'type': 'int', 'default': 0, 'aliases': ['ingest_chunk_rows', 'stream_chunk_rows'], 'checks': ['>=0'], 'options': [], 'section': 'IO'},
    {'name': 'ingest_pipeline_depth', 'type': 'int', 'default': 2, 'aliases': ['ingest_prefetch_depth'], 'checks': ['>=1'], 'options': [], 'section': 'IO'},
]

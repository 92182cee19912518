from repro_torch.evaluation.api import (
    CriteriaRunner,
    Estimator,
    OptimizationCriteria,
    constraint_violation,
    weighted_sum,
)
from repro_torch.evaluation.artifact_store import ArtifactStore
from repro_torch.evaluation.cache import CacheStats, EvaluationCache
from repro_torch.evaluation.cascade import (
    CascadeRunner,
    CohortResult,
    FidelityStage,
    KeepRule,
)
from repro_torch.evaluation.disk_cache import DiskEvaluationCache
from repro_torch.evaluation.estimators import (
    ActivationMemoryEstimator,
    CompiledLatencyEstimator,
    CompiledMemoryEstimator,
    FlopsEstimator,
    ParamCountEstimator,
    TrainedAccuracyEstimator,
)
from repro_torch.evaluation.proxies import GradNormEstimator, SynFlowEstimator
from repro_torch.evaluation.serving import (
    DecodeLatencyEstimator,
    KVCachePeakBytesEstimator,
    P99LatencyEstimator,
    PrefillLatencyEstimator,
    ThroughputEstimator,
)

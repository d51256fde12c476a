from .engine import (DEFAULT_BUCKETS, DeadlineExceeded, DispatchFailed,
                     LUTServeEngine, NoHealthyReplicas, make_forward_fn,
                     pick_bucket, route_least_loaded)
from .metrics import ServeMetrics, percentile
from .registry import (BundleIntegrityError, IntegrityProbe, ServeBundle,
                       TableRegistry, bundle_from_training)
from .tenants import (MultiTenantEngine, SwapReport, Tenant,
                      TenantOverloaded, make_tenant_forward_fn)

__all__ = ["BundleIntegrityError", "DEFAULT_BUCKETS", "DeadlineExceeded",
           "DispatchFailed", "IntegrityProbe", "LUTServeEngine",
           "MultiTenantEngine", "NoHealthyReplicas", "ServeBundle",
           "ServeMetrics", "SwapReport", "TableRegistry", "Tenant",
           "TenantOverloaded", "bundle_from_training", "make_forward_fn",
           "make_tenant_forward_fn", "percentile", "pick_bucket",
           "route_least_loaded"]

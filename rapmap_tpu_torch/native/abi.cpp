// ABI version stamp checked by bindings.py at load: a stale libtqm_native.so
// built from older sources must degrade to the numpy fallbacks, never get
// called through a changed signature (silent memory corruption). Bump
// TQM_ABI_VERSION on ANY extern "C" signature or semantic change.
#include <cstdint>

extern "C" int32_t tqm_abi_version() { return 9; }

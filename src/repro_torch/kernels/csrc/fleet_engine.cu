// fleet_engine: the fast instances of the fleet engine kernel (see
// fleet_engine.cuh): at most 2048 nodes and 8 resource types, with the
// node arrays in shared memory.  The launcher refuses any other shape;
// fleet_engine_wide.cu takes it.
#define FLEET_ENGINE_WIDE 0
#include "fleet_engine.cuh"

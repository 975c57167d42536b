// fleet_engine_wide: the instances of the fleet engine kernel (see
// fleet_engine.cuh) for the shapes its fast ones refuse: more than 2048
// nodes (Best-Fit keys in the key buffer), more than 8 resource types,
// or node arrays past one block's shared memory (the global tier).
#define FLEET_ENGINE_WIDE 1
#include "fleet_engine.cuh"

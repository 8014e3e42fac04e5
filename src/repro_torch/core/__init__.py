"""The DSP core: the switching planner, its cost model, the schedule
executor and the primitives over ``torch.distributed``."""

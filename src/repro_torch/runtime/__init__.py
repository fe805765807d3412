from repro_torch.runtime.ft import (FailureInjector, RunReport,  # noqa: F401
                                    StragglerMonitor, TrainRunner)

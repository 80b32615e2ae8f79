# Stands in for marl_hideandseek_torch/ops/build.py (commit fbfc592641d85df17e7487fd9f1855010c549ebb):
# the frozen reference launches no kernel, so a launch raises.


class CudaKernel:
    def __init__(self, lib_name, fn_name, argtypes):
        self.fn_name = fn_name
        self.launches = 0

    def __call__(self, *args):
        raise RuntimeError(f'the frozen reference launched {self.fn_name}')


def load(name):
    raise RuntimeError(f'the frozen reference loaded kernel library {name}')

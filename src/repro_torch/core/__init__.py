# The paper's system (Algorithm 1) on PyTorch: layout, allocation,
# aggregation and the asynchronous runtime.

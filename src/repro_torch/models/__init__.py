# The paper's multimodal HAR model (Backbone 1), the dense transformer LM
# (phi3, gemma2) and the family-dispatching model API, with their layers.

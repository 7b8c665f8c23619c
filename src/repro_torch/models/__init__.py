# The paper's multimodal HAR model (Backbone 1) and the layers it uses.

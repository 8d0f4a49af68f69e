"""Serving: step factories (``steps``), flat parameter buffers
(``parambuf``), the batched serving driver (``serve``) and continuous
serving beside fused MFL rounds (``continuous``)."""

"""The weight-init kinds a reference's ``param_specs`` names, one module
each: ``draw(leaves, gen, curvature, device)`` gives a tensor for every
(shape, fan_in) of ``leaves`` (all of the kind's leaves, drawn in one
call or a few)."""

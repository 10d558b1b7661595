"""The paper's Execution-Cache-Memory model and the port's pricing with
it (twin of ``repro.ecm``): ``model`` (the ECM prediction), ``machines``
(the paper's four testbeds and the H100), ``kernels`` (the paper's dot
product specs and analyses), ``hopper`` (the roofline form on the card
and the serving forecasts) and ``attribution`` (a phase's wall time
split into compute, HBM, host link, dispatch and an unattributed bin)."""
